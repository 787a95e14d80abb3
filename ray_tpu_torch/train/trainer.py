"""TorchTrainer: data-parallel training over a gang-scheduled actor group.

The port's copy of ``ray_tpu/train/trainer.py`` (reference parity: Ray
Train v2's controller, train/v2/_internal/execution/controller/
controller.py:91 run :446, BackendExecutor,
train/_internal/backend_executor.py:73 (PG creation :230, rank/world
mappings :378), and WorkerGroup, _internal/worker_group.py:102).
Workers are gang-scheduled through a placement group; a worker whose
bundle holds a GPU is pinned to its card (``CUDA_VISIBLE_DEVICES``,
set by the runtime before the actor starts) and the loop finds it as
``cuda:0``. Where the JAX trainer federates one jax runtime across the
gang (``jax.distributed``), this one joins a ``torch.distributed``
process group (train/torch/config.py:66 in the reference): ``nccl``
between GPU workers, ``gloo`` between CPU ones. The host-side control
collective is ``util.collective`` (object-store backed).
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ..exceptions import RayTpuError
from ..util.placement_group import placement_group, remove_placement_group
from ..util.scheduling_strategies import PlacementGroupSchedulingStrategy
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig
from .session import TrainContext, _Session, _set_session


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[Exception]
    path: str
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []


class TrainWorker:
    """Actor hosting one rank of the SPMD group (max_concurrency=2 so the
    controller can drain reports while the user loop runs). `use_gpu`:
    the worker's bundle holds a GPU, so its process group is nccl."""

    def __init__(self, rank: int, world_size: int, use_gpu: bool = False):
        self.rank = rank
        self.world_size = world_size
        self.use_gpu = use_gpu
        self.session: Optional[_Session] = None
        # reported checkpoints, fetchable by monotonically-increasing id.
        # The driver acks each drain round (discard_checkpoints), which is
        # the real cleanup; the size backstop only guards a driver that
        # died mid-run, and is large enough that no single drain round can
        # lose entries before they are fetched.
        self._ckpts: Dict[int, Checkpoint] = {}
        self._ckpt_seq = 0
        self._ckpt_keep = 64
        self._store = None

    def prepare_coordinator(self) -> str:
        """Rank 0 opens the rendezvous store on ITS host (every other
        rank must reach it; the driver's host would be wrong on
        multi-host clusters) and names its endpoint. The store listens
        on a port the OS picks as it binds, so trainers bootstrapping
        side by side on one host cannot race for a probed port."""
        import datetime

        import torch.distributed as dist

        from .._private.state import current_client
        host = current_client().address[0]
        self._store = dist.TCPStore(
            host, 0, self.world_size, True,
            timeout=datetime.timedelta(seconds=300),
            wait_for_workers=False)
        return f"{host}:{self._store.port}"

    def init_torch_distributed(self, coordinator: str) -> str:
        """Join the gang's ``torch.distributed`` process group over
        ``tcp://coordinator`` (rank 0 reuses the store it opened in
        prepare_coordinator); every rank blocks here until the world is
        connected. nccl on a GPU worker, gloo on a CPU one. Returns the
        backend."""
        import datetime

        import torch.distributed as dist
        timeout = datetime.timedelta(seconds=300)
        backend = "nccl" if self.use_gpu else "gloo"
        store = self._store
        if store is None:
            host, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), self.world_size, False,
                                  timeout=timeout)
        dist.init_process_group(backend, store=store, rank=self.rank,
                                world_size=self.world_size,
                                timeout=timeout)
        return backend

    def run(self, train_loop_fn: Callable, loop_config: Optional[Dict],
            context: TrainContext,
            starting_checkpoint) -> Dict[str, Any]:
        from .checkpoint import PackedCheckpoint
        if isinstance(starting_checkpoint, PackedCheckpoint):
            import tempfile
            starting_checkpoint = starting_checkpoint.unpack_into(
                tempfile.mkdtemp(prefix="rtpu_resume_"))
        session = _Session(context, starting_checkpoint)
        self.session = session
        _set_session(session)
        try:
            if loop_config is not None:
                train_loop_fn(loop_config)
            else:
                train_loop_fn()
            return {"status": "ok"}
        except Exception:
            return {"status": "error", "traceback": traceback.format_exc()}
        finally:
            session.finished = True
            _set_session(None)

    def drain_reports(self) -> List[Dict[str, Any]]:
        """Reports with checkpoints replaced by fetch ids: content is
        tarred+shipped only for the one rank the driver selects
        (fetch_checkpoint), not by all N ranks every drain round."""
        if self.session is None:
            return []
        reports = self.session.drain()
        for rep in reports:
            ckpt = rep.get("checkpoint")
            if isinstance(ckpt, Checkpoint):
                ckpt_id = self._ckpt_seq
                self._ckpt_seq += 1
                self._ckpts[ckpt_id] = ckpt
                for old in sorted(self._ckpts)[:-self._ckpt_keep]:
                    del self._ckpts[old]
                rep["checkpoint"] = {"__ckpt_id__": ckpt_id}
        return reports

    def fetch_checkpoint(self, ckpt_id: int):
        """Pack + ship one reported checkpoint's content (driver may be on
        a different host, so local directories don't travel)."""
        return self._ckpts[ckpt_id].pack()

    def discard_checkpoints(self, upto_id: int) -> None:
        """Driver ack: everything at or below upto_id was fetched or
        deliberately skipped this drain round."""
        for cid in [c for c in self._ckpts if c <= upto_id]:
            del self._ckpts[cid]

    def ping(self) -> str:
        return "ok"


class TorchTrainer:
    """Data-parallel trainer (reference DataParallelTrainer equivalent).
    `bootstrap_torch_distributed`: join the workers into one
    ``torch.distributed`` process group before the loop runs (only
    when there are two or more)."""

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 bootstrap_torch_distributed: bool = False):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.bootstrap_torch = bootstrap_torch_distributed
        self._on_report: Optional[Callable[..., None]] = None

    # ------------------------------------------------------------------ fit

    def fit(self, on_report: Optional[Callable[..., None]] = None) -> Result:
        """Run to completion. `on_report(metrics, checkpoint)` streams each
        rank-0 report as it is drained (Tune integration hooks in here so
        schedulers get per-iteration control)."""
        self._on_report = on_report
        storage = self.run_config.resolved_storage_path()
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            storage, num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        starting_ckpt = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []
        while True:
            error = self._run_attempt(manager, starting_ckpt, history)
            if error is None:
                return Result(metrics=history[-1] if history else {},
                              checkpoint=manager.best or manager.latest,
                              error=None, path=storage,
                              metrics_dataframe=history)
            attempt += 1
            if max_failures >= 0 and attempt > max_failures:
                return Result(metrics=history[-1] if history else {},
                              checkpoint=manager.best or manager.latest,
                              error=error, path=storage,
                              metrics_dataframe=history)
            starting_ckpt = manager.latest or starting_ckpt
            time.sleep(1.0)

    def _reserve_workers(self):
        """Reserve this attempt's worker gang. Fixed-size: the full
        num_workers PG or error. Elastic (min_workers set): try sizes from
        num_workers down to min_workers, running with the largest gang the
        cluster can place NOW (reference parity: Train v2 ScalingPolicy
        elastic resize). Returns (pg, n) or (None, error)."""
        sc = self.scaling_config
        sizes = [sc.num_workers]
        if sc.min_workers is not None:
            lo = max(1, sc.min_workers)
            # Seed the probe at what the cluster can fit RIGHT NOW (cheap
            # resource arithmetic), then step down a few sizes to absorb
            # placement races — never a linear scan of 15s timeouts.
            fit = self._max_placeable(sc.worker_bundle())
            start = max(min(sc.num_workers, fit), lo)
            sizes = sorted({start, max(start - 1, lo),
                            max(start // 2, lo), lo}, reverse=True)
        last_err: Optional[Exception] = None
        for i, n in enumerate(sizes):
            pg = placement_group([sc.worker_bundle() for _ in range(n)],
                                 strategy=sc.placement_strategy)
            # full size gets the patient timeout; elastic shrink probes
            # must fail fast so recovery isn't serialized 120s per size
            timeout = 120 if i == 0 and len(sizes) == 1 else 15
            try:
                if pg.ready(timeout=timeout):
                    return (pg, n), None
            except Exception as e:
                last_err = e
            try:
                remove_placement_group(pg)
            except Exception:
                pass
        return None, (last_err or RayTpuError(
            f"no worker gang in [{sizes[-1]}, {sizes[0]}] x "
            f"{self.scaling_config.worker_bundle()} placeable"))

    def _max_placeable(self, bundle: Dict[str, float]) -> int:
        """How many copies of `bundle` the cluster can place NOW under the
        configured strategy: STRICT_PACK = all bundles on one node (max
        per-node fit); STRICT_SPREAD = one bundle per node (count of
        fitting nodes); PACK/SPREAD are soft (sum of per-node fits)."""
        from .._private import state
        strategy = self.scaling_config.placement_strategy
        per_node = []
        try:
            nodes = state.current_client().nodes()
        except Exception:
            return 1
        for node in nodes:
            if not node.get("alive", True):
                continue
            avail = node.get("resources_available") or {}
            fits = min((int(avail.get(k, 0.0) // v)
                        for k, v in bundle.items() if v > 0),
                       default=0)
            per_node.append(max(fits, 0))
        if not per_node:
            return 1
        if strategy == "STRICT_PACK":
            total = max(per_node)
        elif strategy == "STRICT_SPREAD":
            total = sum(1 for f in per_node if f > 0)
        else:
            total = sum(per_node)
        return max(total, 1)

    def _run_attempt(self, manager: CheckpointManager,
                     starting_ckpt: Optional[Checkpoint],
                     history: List[Dict[str, Any]]) -> Optional[Exception]:
        sc = self.scaling_config
        workers = []
        reserved, err = self._reserve_workers()
        if reserved is None:
            return err
        pg, n = reserved
        try:
            WorkerCls = rt.remote(TrainWorker)
            worker_res = sc.worker_bundle()
            use_gpu = worker_res.get("GPU", 0) > 0
            workers = [
                WorkerCls.options(
                    max_concurrency=2,
                    num_cpus=worker_res.get("CPU", 0),
                    resources={k: v for k, v in worker_res.items()
                               if k != "CPU"},
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        pg, i),
                ).remote(i, n, use_gpu)
                for i in range(n)
            ]
            if self.bootstrap_torch and n > 1:
                # two-phase: rank 0 opens the store on its own host,
                # then every rank joins (each init_torch_distributed
                # blocks until the full world is connected). Failures
                # return as attempt errors so FailureConfig retries.
                try:
                    coordinator = rt.get(
                        workers[0].prepare_coordinator.remote(),
                        timeout=60)
                    rt.get([w.init_torch_distributed.remote(coordinator)
                            for w in workers], timeout=300)
                except Exception as e:
                    return e
            contexts = [TrainContext(
                world_rank=i, world_size=n, local_rank=0,
                local_world_size=1, node_rank=i,
                experiment_name=self.run_config.name or "train_run",
                storage_path=manager.storage_path,
                group_name=f"train_{id(self)}",
            ) for i in range(n)]
            packed_start = starting_ckpt.pack() if starting_ckpt else None
            run_refs = [w.run.remote(self.train_loop,
                                     self.train_loop_config,
                                     contexts[i], packed_start)
                        for i, w in enumerate(workers)]
            return self._poll(workers, run_refs, manager, history)
        finally:
            for w in workers:
                try:
                    rt.kill(w)
                except Exception:
                    pass
            try:
                remove_placement_group(pg)
            except Exception:
                pass

    def _poll(self, workers, run_refs, manager: CheckpointManager,
              history: List[Dict[str, Any]]) -> Optional[Exception]:
        pending = list(run_refs)
        while True:
            self._drain(workers, manager, history)
            ready, pending = rt.wait(
                pending, num_returns=len(pending), timeout=0.5)
            for ref in ready:
                try:
                    status = rt.get(ref)
                except Exception as e:
                    error = e
                else:
                    if status.get("status") != "error":
                        continue
                    error = RayTpuError(
                        f"train loop failed:\n{status.get('traceback')}")
                # what the loop reported before it failed still counts:
                # its last checkpoint is the one a restart resumes from
                # (the JAX trainer returns here without this drain and
                # loses the reports of the poll window that failed)
                self._drain(workers, manager, history)
                return error
            if not pending:
                self._drain(workers, manager, history)
                return None

    def _drain(self, workers, manager: CheckpointManager,
               history: List[Dict[str, Any]]) -> None:
        try:
            all_reports = rt.get(
                [w.drain_reports.remote() for w in workers], timeout=30)
        except Exception:
            return
        # Rank 0's metrics define the run history (reference semantics);
        # any rank may attach a checkpoint — the lowest reporting rank wins
        # when several report in the same drain round (SPMD loops typically
        # report identical global state from every rank), and only that
        # rank's content is packed + shipped.
        ckpt_rank = min((rank for rank, reports in enumerate(all_reports)
                         if any(r.get("checkpoint") is not None
                                for r in reports)), default=0)
        # Pass 1: fetch + persist ckpt_rank's checkpoints, keyed by report
        # round so rank 0's lockstep report in the same round carries them
        # (the checkpoint must reach the session even when ckpt_rank != 0).
        persisted_by_round: Dict[int, Any] = {}
        for i, rep in enumerate(all_reports[ckpt_rank]
                                if ckpt_rank < len(all_reports) else []):
            ckpt = rep.get("checkpoint")
            if ckpt is None:
                continue
            try:
                packed = rt.get(
                    workers[ckpt_rank].fetch_checkpoint.remote(
                        ckpt["__ckpt_id__"]), timeout=120)
            except Exception:
                packed = None
            if packed is not None:
                persisted_by_round[i] = manager.register(
                    packed, rep.get("metrics") or {})
        # Ack every rank's checkpoint entries for this round so workers
        # free them (non-selected ranks' content is never fetched).
        for rank, reports in enumerate(all_reports):
            ids = [rep["checkpoint"]["__ckpt_id__"] for rep in reports
                   if rep.get("checkpoint") is not None]
            if ids:
                workers[rank].discard_checkpoints.remote(max(ids))
        # Pass 2: rank 0's metrics define the run history.
        for i, rep in enumerate(all_reports[0] if all_reports else []):
            metrics = dict(rep.get("metrics") or {})
            persisted = persisted_by_round.get(i)
            if persisted is not None:
                metrics["_checkpoint_path"] = persisted.path
            history.append(metrics)
            if self._on_report is not None:
                self._on_report(dict(metrics), persisted)


# Reference-parity alias: the generic data-parallel entry point.
DataParallelTrainer = TorchTrainer


def _trainer_as_trainable(trainer: "TorchTrainer") -> type:
    """Wrap a TorchTrainer into a Tune function-trainable: the trial config
    is merged into train_loop_config, fit() runs inside the trial actor,
    and per-report metrics stream to Tune (reference:
    base_trainer.py:808 as_trainable — a trainer *is* a one-trial Tune
    experiment there too)."""
    import copy as _copy

    from ..tune.trainable import wrap_function

    def _tune_fn(config):
        from ..tune import trainable as _tune_session
        run = _copy.copy(trainer)
        run.train_loop_config = {**(trainer.train_loop_config or {}),
                                 **config}
        streamed = [0]

        def on_report(metrics, checkpoint=None):
            # Live bridge into the Tune session: blocks until the
            # controller consumes, so ASHA/PBT decisions land while the
            # workers still compute, not after fit() finished.
            streamed[0] += 1
            _tune_session.report(dict(metrics), checkpoint=checkpoint)

        result = run.fit(on_report=on_report)
        if result.error is not None:
            raise result.error
        if not streamed[0] and result.metrics:
            _tune_session.report(dict(result.metrics))

    fn = _tune_fn
    fn.__name__ = "torch_trainer"
    return wrap_function(fn)


TorchTrainer.as_trainable = _trainer_as_trainable


def _tune_resources_per_trial(trainer: "TorchTrainer") -> Dict[str, float]:
    # A trial actor only coordinates; the trainer's own worker group holds
    # the real resources.
    return {"CPU": 0.1}


TorchTrainer.tune_resources_per_trial = _tune_resources_per_trial
