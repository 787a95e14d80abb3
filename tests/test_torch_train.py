"""ray_tpu_torch.train against ray_tpu.train: ``test_train.py``'s eight
cases mirrored on the port's runtime (CPU workers; a fake node of two
GPUs for the pinning case), plus the tensor-tree checkpoint and the
refusal of the TPU fields.

The reference's two JAX cases become the port's counterparts: the Llama
loop runs the port's ``TrainStepBundle`` (``debug``, float32, the CPU)
inside a worker from the JAX bundle's initial parameters, and its losses
equal the JAX bundle's on the same tokens within
``test_torch_training.py``'s tolerance (rtol 1e-5: the same float32
operations summed in other orders); the multi-host case joins two
workers into one ``torch.distributed`` process group over gloo."""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.accelerators import gpu as gpu_mod
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                 FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)


@pytest.fixture(scope="module")
def ray_start():
    mp = pytest.MonkeyPatch()
    mp.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    mp.setattr(gpu_mod, "_NODE_VISIBLE", None)
    rt.init(num_cpus=8, num_gpus=2)
    yield rt
    rt.shutdown()
    mp.undo()


def test_single_worker_reports(ray_start, tmp_path):
    def loop(config):
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1)})

    trainer = TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_dataframe) == 3


def test_multi_worker_context(ray_start, tmp_path):
    def loop():
        ctx = train.get_context()
        train.report({"rank": ctx.world_rank, "world": ctx.world_size})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    # history holds rank 0's reports only
    assert result.metrics == {"rank": 0, "world": 3}


def test_checkpointing_and_retention(ray_start, tmp_path):
    def loop(config):
        import tempfile
        for step in range(4):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "model.txt"), "w") as f:
                f.write(f"weights-{step}")
            train.report({"step": step, "score": float(step)},
                         checkpoint=Checkpoint.from_directory(d))

    trainer = TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t3", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score")))
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    with open(os.path.join(result.checkpoint.path, "model.txt")) as f:
        assert f.read() == "weights-3"
    ckpt_dirs = [d for d in os.listdir(os.path.join(str(tmp_path), "t3"))
                 if d.startswith("checkpoint_")]
    assert len(ckpt_dirs) == 2


def test_failure_restart_resumes_from_checkpoint(ray_start, tmp_path):
    marker = str(tmp_path / "crashed_once")

    def loop(config):
        import tempfile
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.as_directory(), "step.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 4):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "step.txt"), "w") as f:
                f.write(str(step))
            train.report({"step": step},
                         checkpoint=Checkpoint.from_directory(d))
            if step == 1 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("simulated failure at step 1")

    trainer = TorchTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t4", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    steps = [m["step"] for m in result.metrics_dataframe]
    assert 2 in steps and steps.count(0) == 1, steps


def test_restart_resumes_from_the_last_report_before_the_failure(
        ray_start, tmp_path):
    """Reports made in the poll window in which the loop fails are still
    drained: the restart resumes after the last checkpoint reported (the
    JAX trainer drops that window and restarts from an older one, or
    from scratch)."""
    marker = str(tmp_path / "crashed_once")

    def loop(config):
        import tempfile
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.as_directory(), "step.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 5):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "step.txt"), "w") as f:
                f.write(str(step))
            train.report({"step": step, "start": start},
                         checkpoint=Checkpoint.from_directory(d))
            if step == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("simulated failure at step 2")

    trainer = TorchTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t4b", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None
    got = [(m["step"], m["start"]) for m in result.metrics_dataframe]
    assert got == [(0, 0), (1, 0), (2, 0), (3, 3), (4, 3)], got


def test_failure_budget_exhausted(ray_start, tmp_path):
    def loop():
        raise ValueError("always fails")

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t5", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)))
    result = trainer.fit()
    assert result.error is not None
    assert "always fails" in str(result.error)


def _jax_bundle_losses(steps):
    """The JAX bundle's first parameters, tokens and losses (float32
    ``debug`` at xla attention on a one-device CPU mesh)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jtr
    from ray_tpu.parallel import MeshSpec

    jc = jl.config("debug", dtype=jnp.float32, attention_impl="xla",
                   loss_chunk=16)
    mesh = MeshSpec(dp=1, fsdp=1, sp=1, tp=1).build([jax.devices()[0]])
    jb = jtr.TrainStepBundle(jc, mesh, optimizer=jtr.default_optimizer(
        learning_rate=1e-3, warmup_steps=1, total_steps=10))
    st = jb.init_state(0)
    p0 = jax.tree_util.tree_map(np.asarray, st[0])
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 64)).astype(np.int32)
    losses = []
    jt = jb.shard_batch(jnp.asarray(toks))
    for _ in range(steps):
        st, m = jb.step(st, jt)
        losses.append(float(m["loss"]))
    return p0, toks, losses


def test_torch_training_loop_single_worker(ray_start, tmp_path):
    """End-to-end: the port's Llama training inside a train worker,
    from the JAX bundle's initial parameters, loss for loss."""
    p0, toks, want = _jax_bundle_losses(3)

    def loop(config):
        import torch
        torch.set_num_threads(2)
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.training import (TrainStepBundle,
                                                   default_optimizer)

        cfg = llama.config("debug", dtype=torch.float32,
                           attention_impl="xla", loss_chunk=16)
        bundle = TrainStepBundle(cfg, "cpu", optimizer=default_optimizer(
            learning_rate=1e-3, warmup_steps=1, total_steps=10))
        state = bundle.state_from_numpy(config["params"])
        tokens = bundle.shard_batch(config["tokens"])
        for step in range(3):
            state, metrics = bundle.step(state, tokens)
            train.report({"step": step, "loss": metrics["loss"].item(),
                          "device": str(tokens.device)})

    trainer = TorchTrainer(
        loop, train_loop_config={"params": p0, "tokens": toks},
        scaling_config=ScalingConfig(num_workers=1, cpus_per_worker=2),
        run_config=RunConfig(name="t6", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    got = [m["loss"] for m in result.metrics_dataframe]
    assert result.metrics["device"] == "cpu"
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_elastic_trainer_runs_with_available_workers(ray_start, tmp_path):
    """ScalingConfig(min_workers=...) runs with the largest placeable gang
    instead of blocking on the full one (Train v2 ScalingPolicy parity)."""
    def loop(config=None):
        from ray_tpu_torch.train import session
        ctx = session.get_context()
        session.report({"world_size": ctx.world_size, "loss": 1.0})

    # the 8-CPU test cluster cannot place 64 x 1-CPU workers; elastic
    # shrinks until the gang fits
    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=64, cpus_per_worker=1.0,
                                     min_workers=1),
        run_config=RunConfig(name="elastic-test",
                             storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    assert 1 <= result.metrics["world_size"] < 64


def test_multihost_torch_distributed_train(ray_start, tmp_path):
    """Two TrainWorker processes join one torch.distributed process
    group (gloo: CPU workers; rank 0 hosts the store on its own node)
    and run a cross-process reduction."""
    def loop():
        import torch
        import torch.distributed as dist

        ctx = train.get_context()
        x = torch.full((4,), float(ctx.world_rank + 1))
        dist.all_reduce(x)
        train.report({"total": float(x.sum()),
                      "world": dist.get_world_size(),
                      "rank": dist.get_rank(),
                      "backend": dist.get_backend()})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="t8", storage_path=str(tmp_path)),
        bootstrap_torch_distributed=True)
    result = trainer.fit()
    assert result.error is None, result.error
    m = result.metrics
    # each rank contributes 4 x (rank + 1): 4 x 1 + 4 x 2 = 12
    assert m == {"total": 12.0, "world": 2, "rank": 0, "backend": "gloo"}


def test_gpu_workers_pinned_to_their_cards(ray_start, tmp_path):
    """use_gpu=True: each worker's bundle holds a GPU, the daemon pins
    it before the loop runs (a fake node: the pin shows in
    CUDA_VISIBLE_DEVICES, no card needed), and the cards are free
    after."""
    def loop():
        ctx = train.get_context()
        train.report({"rank": ctx.world_rank,
                      "cvd": os.environ.get("CUDA_VISIBLE_DEVICES")})

    seen = {}
    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(name="t9", storage_path=str(tmp_path)))
    assert trainer.scaling_config.worker_bundle() == {"CPU": 1.0,
                                                      "GPU": 1.0}
    result = trainer.fit(on_report=lambda m, c: seen.update(m))
    assert result.error is None, result.error
    assert seen["rank"] == 0 and seen["cvd"] in ("0", "1")
    daemon = rt.current_runtime().head_daemon
    import time
    deadline = time.time() + 30
    while time.time() < deadline and len(daemon._free_gpus) < 2:
        time.sleep(0.1)
    assert sorted(daemon._free_gpus) == [0, 1]


def test_scaling_config_gpu_fields_and_tpu_refused():
    sc = ScalingConfig(use_gpu=True, gpus_per_worker=2,
                       accelerator_type="NVIDIA-H100-80GB-HBM3")
    assert sc.worker_bundle() == {"CPU": 1.0, "GPU": 2.0,
                                  "GPU-NVIDIA-H100-80GB-HBM3": 2.0}
    assert ScalingConfig().worker_bundle() == {"CPU": 1.0}
    for kw in ({"use_tpu": True}, {"tpus_per_worker": 4}):
        with pytest.raises(ValueError, match="use_gpu"):
            ScalingConfig(**kw)
    assert TorchTrainer(lambda: None).tune_resources_per_trial() == {
        "CPU": 0.1}
    assert train.DataParallelTrainer is TorchTrainer


def test_save_and_load_pytree_round_trip_bit_exact(tmp_path):
    g = np.random.default_rng(0)
    tree = {"params": {"w": torch.from_numpy(
                           g.standard_normal((5, 3)).astype(np.float32)),
                       "b": torch.from_numpy(g.standard_normal(4)).to(
                           torch.bfloat16)},
            "opt": [g.integers(0, 9, (2, 3)).astype(np.int32),
                    (3, 0.5, None, "adamw")],
            "count": np.int64(7), "empty": torch.zeros(0, 4)}
    ck = Checkpoint.save_pytree(tree, str(tmp_path / "ck"))
    assert sorted(os.listdir(os.path.join(ck.path, "pytree"))) == [
        "tensors.safetensors", "tree.json"]
    back = ck.load_pytree(device="cpu")
    for k in ("w", "b"):
        a, b = tree["params"][k], back["params"][k]
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(b.view(torch.uint8), a.view(torch.uint8))
    assert back["opt"][0].dtype == np.int32
    np.testing.assert_array_equal(back["opt"][0], tree["opt"][0])
    assert back["opt"][1] == (3, 0.5, None, "adamw")
    assert back["count"] == 7 and isinstance(back["count"], np.int64)
    assert back["empty"].shape == (0, 4)
    # with a tree to match: each tensor takes the leaf's dtype
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.float64),
                       "b": torch.zeros(4, dtype=torch.bfloat16)},
            "opt": [None, (None,) * 4], "count": None, "empty": None}
    cast = ck.load_pytree(like, device="cpu")
    assert cast["params"]["w"].dtype == torch.float64
    # the default device is the card: refused without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.load_pytree()
