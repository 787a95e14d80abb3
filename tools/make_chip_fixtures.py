"""Write the reference initial weights chip_smoke.py's learning gates
start from, drawn by the JAX package (run on the CPU):

    JAX_PLATFORMS=cpu python -m tools.make_chip_fixtures

`chip_smoke_data/sac_pendulum_jax_init_seed0.npz`: the JAX SACLearner's
initial parameters at seed 0 for Pendulum (``action_scale=2.0``, the
configuration of ``test_sac_learns_pendulum``), flax leaves flattened
to "layer/kernel" and "layer/bias" keys. SAC's Pendulum gate compares
the curve with its own first return, which the initial draw sets, so
the port's gate (``tests/test_torch_rllib_offpolicy.py``, phase 6e on
the card) starts where the JAX one does; the card cannot import JAX.
``tests/test_torch_rllib_offpolicy.py`` holds the file to a fresh draw.
"""

import os

import jax
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke_data")
SAC_INIT = "sac_pendulum_jax_init_seed0.npz"


def sac_init_arrays():
    from ray_tpu.rllib.algorithms.sac import SACModule
    from ray_tpu.rllib.env.jax_env import Pendulum
    tree = SACModule(Pendulum().spec, action_scale=2.0).init(
        jax.random.PRNGKey(0))["params"]
    return {f"{layer}/{leaf}": np.asarray(v)
            for layer, d in tree.items() for leaf, v in d.items()}


def main():
    os.makedirs(OUT, exist_ok=True)
    np.savez(os.path.join(OUT, SAC_INIT), **sac_init_arrays())


if __name__ == "__main__":
    main()
