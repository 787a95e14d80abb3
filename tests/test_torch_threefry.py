"""ray_tpu_torch.ops.threefry against jax.random (threefry2x32, JAX's
default PRNG; jax_threefry_partitionable on; Gumbel mode "low").

- PRNGKey + fold_in key data, random bits and uniforms: bit-equal.
- Gumbel values: -log(-log(u)) from bit-equal uniforms. JAX's CPU log
  (XLA's own polynomial) and torch's (SLEEF, <= 1 ulp) each round within
  an ulp of the true value but not always to the same float, so the two
  sides may differ there. Bound: |a - b| <= 2**-22 * max(1, |g|). An ulp
  of the inner log moves -log(u) by at most 2**-23 relative, which moves
  the outer log by at most 2**-23 absolute; the outer log's own rounding
  adds up to 2**-23 * |g|. Where both logs agree the values are equal.
- The engine's `_sample` fed `row_gumbel` draws the tokens of
  jax.vmap(jax.random.categorical)(row_keys, filtered).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.ops import threefry as tf

TINY = float(np.finfo(np.float32).tiny)
GUMBEL_TOL = 2.0 ** -22


def _i32(v):
    return torch.as_tensor(np.asarray(v, np.int32))


def _port_key(seed, index):
    return tf.fold_in(tf.prng_key(_i32(seed)), _i32(index))


def _jax_key(seed, index):
    return jax.random.fold_in(jax.random.PRNGKey(seed), index)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 77, 2 ** 31 - 1])
def test_prng_key_and_fold_in_match_jax(seed):
    idx = [0, 1, 255, 65536, 2 ** 31 - 1]
    k1, k2 = _port_key([seed] * len(idx), idx)
    got = np.stack([_u32(k1), _u32(k2)], axis=1)
    want = np.stack([np.asarray(jax.random.key_data(_jax_key(seed, i)))
                     for i in idx])
    np.testing.assert_array_equal(got, want)
    k1, k2 = tf.prng_key(_i32(seed))
    np.testing.assert_array_equal(
        [int(k1), int(k2)],
        np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("vocab", [50, 128256])
@pytest.mark.parametrize("seed,index", [(0, 0), (77, 255), (2 ** 31 - 1,
                                                           65536)])
def test_bits_and_uniform_bit_equal_to_jax(vocab, seed, index):
    key, jkey = _port_key(seed, index), _jax_key(seed, index)
    np.testing.assert_array_equal(
        _u32(tf.random_bits(key, vocab)),
        np.asarray(jax.random.bits(jkey, (vocab,))))
    # the ranges the sampler uses: hi - lo rounds to 1.0, so f * (hi - lo)
    # + lo is exact whether or not a compiler fuses it into one fma (XLA's
    # CPU backend does, so a wider range can land an ulp apart)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
        got = tf.uniform(key, vocab, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jkey, (vocab,), jnp.float32,
                                             minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("vocab", [50, 128256])
def test_gumbel_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    for seed, index in zip(rng.integers(0, 2 ** 31 - 1, 4),
                           rng.integers(0, 2 ** 31 - 1, 4)):
        got = tf.gumbel(_port_key(seed, index), vocab).numpy()
        want = np.asarray(jax.random.gumbel(_jax_key(int(seed), int(index)),
                                            (vocab,), jnp.float32))
        assert np.isfinite(got).all()
        bound = GUMBEL_TOL * np.maximum(1.0, np.abs(want))
        assert (np.abs(got - want) <= bound).all(), \
            np.abs(got - want).max()
    # the uniform both logs start from is bit-equal, so equal logs give
    # equal values: most columns agree to the bit
    assert np.mean(got == want) > 0.5


def test_row_gumbel_rows_are_jax_row_keys():
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2 ** 31 - 1, 5).astype(np.int32)
    idx = rng.integers(0, 4096, 5).astype(np.int32)
    got = tf.row_gumbel(_i32(seeds), _i32(idx), 300).numpy()
    keys = je._row_sample_keys(jnp.asarray(seeds), jnp.asarray(idx))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (300,), jnp.float32))(keys))
    assert (np.abs(got - want)
            <= GUMBEL_TOL * np.maximum(1.0, np.abs(want))).all()
    np.testing.assert_array_equal(
        tf.row_gumbel(_i32(seeds), _i32(idx), 300).numpy(), got)
    # the kernel's earlier stages, as the card's checks read them
    bits = tf.row_noise(_i32(seeds), _i32(idx), 300, "bits").numpy()
    np.testing.assert_array_equal(
        bits.view(np.uint32),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (300,)))(keys)))
    uni = tf.row_noise(_i32(seeds), _i32(idx), 300, "uniform").numpy()
    np.testing.assert_array_equal(
        uni.view(np.uint32),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (300,), jnp.float32, minval=TINY, maxval=1.0))(keys)
        ).view(np.uint32))


def test_categorical_matches_jax():
    rng = np.random.default_rng(2)
    for trial in range(8):
        logits = (rng.normal(size=(64,)) * 4).astype(np.float32)
        seed, index = int(rng.integers(0, 2 ** 31 - 1)), trial
        got = int(tf.categorical(_port_key(seed, index),
                                 torch.from_numpy(logits)))
        want = int(jax.random.categorical(_jax_key(seed, index),
                                          jnp.asarray(logits)))
        assert got == want, trial


SAMPLE_CASES = [
    # temps, top_ps, top_ks, rep_pens
    ([0.8, 1.0, 0.0, 1.5], [0.9, 1.0, 1.0, 0.5], [20, 0, 0, 5],
     [1.1, 1.0, 1.0, 1.3]),
    ([1.0, 0.7, 2.0, 0.3], [1.0, 0.95, 0.8, 1.0], [0, 50, 3, 0],
     [1.0, 1.0, 1.2, 1.0]),
]


@pytest.mark.parametrize("vocab", [64, 1000])
@pytest.mark.parametrize("temps,top_ps,top_ks,rep_pens", SAMPLE_CASES)
def test_sample_with_row_gumbel_matches_jax_categorical(vocab, temps, top_ps,
                                                        top_ks, rep_pens):
    """The port's sampler on the port's noise draws the JAX sampler's
    tokens (jax.vmap(jax.random.categorical) over the per-row keys)."""
    rng = np.random.default_rng(vocab + len(temps))
    B = len(temps)
    f32 = lambda a: np.asarray(a, np.float32)
    for trial in range(6):
        logits = (rng.normal(size=(B, vocab)) * 3).astype(np.float32)
        seen = rng.random((B, vocab)) < 0.1
        seeds = rng.integers(0, 2 ** 31 - 1, B).astype(np.int32)
        idx = rng.integers(0, 10000, B).astype(np.int32)
        ref = np.asarray(je._sample(
            jnp.asarray(logits), None, jnp.asarray(f32(temps)),
            jnp.asarray(f32(top_ps)), jnp.asarray(np.int32(top_ks)),
            jnp.asarray(f32(rep_pens)), jnp.asarray(seen), False,
            row_keys=je._row_sample_keys(jnp.asarray(seeds),
                                         jnp.asarray(idx))))
        out = te._sample(
            torch.from_numpy(logits), torch.from_numpy(f32(temps)),
            torch.from_numpy(f32(top_ps)), torch.tensor(top_ks,
                                                        dtype=torch.int32),
            torch.from_numpy(f32(rep_pens)), torch.from_numpy(seen),
            gumbel=tf.row_gumbel(_i32(seeds), _i32(idx), vocab))
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"{trial}")


def test_row_gumbel_checks_its_arguments():
    ok = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        tf.row_gumbel(ok.long(), ok, 10)
    with pytest.raises(ValueError):
        tf.row_gumbel(ok, ok[:2], 10)
    with pytest.raises(ValueError):
        tf.row_gumbel(ok, ok, 0)
    with pytest.raises(ValueError):
        tf.row_noise(ok, ok, 10, "normal")
