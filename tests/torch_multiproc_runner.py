"""Two (or more) real processes of gdmix_tpu_torch over a gloo process group
on the CPU, for the multi-process parity tests.

    python tests/torch_multiproc_runner.py <task> <json args>

runs in each child: it joins the job its environment names (the JAX
package's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID contract,
through workflow/distributed.py maybe_initialize_distributed on the CPU),
runs one task and prints its result as one line `RESULT {json}`:

  fe        FixedEffectLRModel.train on the process's file or sample shard
  pipeline  the in-memory pipeline (InMemoryPipeline.run)
  single_node  `workflow.main --mode distributed`
  tower     DeepTowerModel.train

`launch` is the parent's side: it starts the children on a free port and
returns their results in rank order. The children import no JAX.
"""
import hashlib
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_env(rank: int, nproc: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               NUM_PROCESSES=str(nproc), PROCESS_ID=str(rank),
               PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return env


def run_procs(cmds, timeout: float = 300.0):
    """Start one child a command (cmd, env); every child's output, in
    order. A child that fails or outlives `timeout` fails the caller."""
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, env in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
    return outs


def launch(task: str, args: dict, nproc: int = 2, timeout: float = 300.0):
    """The children's results of `task`, in rank order."""
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), task, json.dumps(args)]
    outs = run_procs([(cmd, job_env(r, nproc, port)) for r in range(nproc)],
                     timeout)
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("RESULT "))[7:])
            for out in outs]


def sha(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _ctx():
    from gdmix_tpu_torch import constants
    from gdmix_tpu_torch.parallel.process_group import \
        process_index_and_count
    rank, nproc = process_index_and_count()
    return {constants.TASK_INDEX: rank, constants.NUM_WORKERS: nproc,
            constants.IS_CHIEF: rank == 0}


def task_fe(a):
    """The JAX package's tests/multiproc_runner.py, on the port."""
    from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu_torch.params import FixedLRParams, Params
    root = a["root"]
    mp = FixedLRParams(
        metadata_file=os.path.join(root, "tensor_metadata.json"),
        output_model_dir=os.path.join(root, "models_mp"),
        training_data_dir=os.path.join(root, "trainingData"),
        feature_bag="global",
        feature_file=os.path.join(root, "features.csv"),
        l2_reg_weight=0.7, regularize_bias=False, dtype="float64",
        lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10,
        num_of_lbfgs_iterations=500, sparsity_threshold=0.0,
        fixed_effect_variance_mode=a.get("variance_mode"),
        stream_chunk_rows=a.get("stream_rows", 0), **a.get("extra", {}))
    bp = Params(action="train", stage="fixed_effect",
                model_type="logistic_regression",
                label_column_name="response", uid_column_name="uid",
                weight_column_name="weight",
                prediction_score_column_name="predictionScore",
                training_score_dir=os.path.join(root, "scores_mp"))
    model = FixedEffectLRModel(mp, bp, device="cpu")
    model.train(mp.training_data_dir, None, mp.metadata_file,
                mp.output_model_dir, _ctx(), bp)
    batch = model._train_batch_cache[0]
    return dict(coefficients=model.model_coefficients.tolist(),
                sha=sha(model.model_coefficients),
                variances=(None if model.variances is None
                           else model.variances.tolist()),
                rows=int(batch.labels.shape[0]),
                funcalls=model.last_fit["funcalls"],
                allreduce_calls=model.last_fit["allreduce_calls"],
                hybrid=model.build_hybrid_aux_for(batch) is not None)


def task_pipeline(a):
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.workflow.config import WorkflowConfig
    from gdmix_tpu_torch.workflow.pipeline import InMemoryPipeline
    planes = []
    for name in ("fit_records_sharded", "fit_groups"):
        orig = getattr(RandomEffectLRModel, name)

        def spy(self, *args, __orig=orig, __name=name, **kw):
            planes.append((__name, self.model_params.partition_entity))
            return __orig(self, *args, **kw)
        setattr(RandomEffectLRModel, name, spy)
    pipe = InMemoryPipeline(WorkflowConfig.from_file(a["config"]),
                            num_sweeps=a.get("num_sweeps", 2),
                            re_mode=a["re_mode"], device="cpu")
    metrics = pipe.run()
    return dict(metrics=metrics, exchanges=pipe.exchanges, planes=planes)


def task_single_node(a):
    """`workflow.main --mode distributed`, counting the chief-only jobs
    this process ran (ROADMAP C.14)."""
    from gdmix_tpu_torch.workflow import main, single_node
    jobs = {}
    for name in ("_create_subdirs", "run_partitioner", "run_evaluator"):
        orig = getattr(single_node, name)

        def counted(*args, __orig=orig, __name=name, **kw):
            jobs[__name] = jobs.get(__name, 0) + 1
            return __orig(*args, **kw)
        setattr(single_node, name, counted)
    metrics = main.main(["--config_path", a["config"], "--mode",
                         "distributed", "--device", "cpu"])
    return dict(metrics=metrics, jobs=jobs)


def task_tower(a):
    from gdmix_tpu_torch.models.deep_tower import (DeepTowerModel,
                                                   DeepTowerParams)
    from gdmix_tpu_torch.params import Params
    model = DeepTowerModel(DeepTowerParams(**a["model"]),
                           Params(**a["base"]), device="cpu")
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, _ctx(),
                model.base_params)
    h = hashlib.sha256()
    for v in model.module.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return dict(sha=h.hexdigest(), fit=model.last_fit)


if __name__ == "__main__":
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, ROOT)
    from gdmix_tpu_torch.workflow.distributed import \
        maybe_initialize_distributed
    joined = maybe_initialize_distributed("cpu")
    task, args = sys.argv[1], json.loads(sys.argv[2])
    result = {"pipeline": task_pipeline, "fe": task_fe,
              "single_node": task_single_node,
              "tower": task_tower}[task](args)
    result.update(rank=joined["process_id"], backend=joined["backend"])
    print("RESULT " + json.dumps(result), flush=True)
