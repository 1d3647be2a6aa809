"""The port's kubernetes surface (gdmix_tpu_torch/workflow/k8s.py, a
guarded copy of the JAX package's): manifests equal to the JAX package's
compile_kubernetes on the same config but for the listed differences
(the trainer CLI's module, nvidia.com/gpu cards in place of TPU chips, the
coordinator port's name), and the kubectl launcher driven against a fake
kubectl, as tests/test_k8s_workflow.py does for JAX."""
import json
import os

import pytest
import yaml

from gdmix_tpu.workflow.k8s import compile_kubernetes as jax_compile
from gdmix_tpu_torch.workflow.k8s import (compile_kubernetes, job_manifest,
                                          launch_dag, launch_job)
from tests.test_k8s_workflow import _fake_kubectl, _write_cfg

KNOBS = {"namespace": "gdmix", "image": "gdmix:v1", "num_hosts": 4,
         "memory": "8Gi",
         "data_volume": {"mountPath": "/data",
                         "persistentVolumeClaim": {"claimName": "gdmix"}}}


def _docs(out, entry):
    with open(os.path.join(out, entry["manifest"])) as f:
        return list(yaml.safe_load_all(f))


def _as_jax(doc):
    """A port manifest with the listed differences mapped back to the JAX
    package's form."""
    s = json.dumps(doc).replace("gdmix_tpu_torch.", "gdmix_tpu.")
    s = s.replace('"nvidia.com/gpu": 1', '"google.com/tpu": 4')
    return json.loads(s.replace('"name": "coordinator"',
                                '"name": "jax-coordinator"'))


def test_manifests_match_jax(tmp_path):
    cfg = _write_cfg(tmp_path, extras={"k8s_config": KNOBS})
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = jax_compile(cfg, jout), compile_kubernetes(cfg, tout)
    assert len(got) == 8
    assert [{k: j[k] for k in ("name", "manifest", "depends_on")}
            for j in got] == [
        {k: j[k] for k in ("name", "manifest", "depends_on")} for j in want]
    for tj, jj in zip(got, want):
        tdocs, jdocs = _docs(tout, tj), _docs(jout, jj)
        assert [_as_jax(d) for d in tdocs] == jdocs, tj["name"]
        if tj["type"] != "gdmix_tpu_train":
            continue
        svc, job = tdocs
        assert svc["spec"]["ports"][0]["name"] == "coordinator"
        pod = job["spec"]["template"]["spec"]
        c = pod["containers"][0]
        assert c["command"][:3] == ["python", "-m", "gdmix_tpu_torch.gdmix"]
        assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
        assert "nodeSelector" not in pod
        env = {e["name"]: e for e in c["env"]}
        # the env contract maybe_initialize_distributed reads
        assert env["NUM_PROCESSES"]["value"] == "4"
        assert env["COORDINATOR_ADDRESS"]["value"] == \
            f"{job['metadata']['name']}-0.{job['metadata']['name']}." \
            "gdmix.svc:8476"
        assert "job-completion-index" in \
            env["PROCESS_ID"]["valueFrom"]["fieldRef"]["fieldPath"]
    with open(os.path.join(tout, "plan.json")) as f:
        assert json.load(f)["namespace"] == "gdmix"


def test_gpu_knobs_and_single_host(tmp_path):
    docs = job_manifest({"name": "t", "type": "gdmix_tpu_train",
                         "depends_on": [], "command": ["true"]},
                        num_hosts=2, gpus_per_host=8)
    assert [d["kind"] for d in docs] == ["Service", "Job"]
    assert docs[0]["spec"]["publishNotReadyAddresses"] is True
    limits = docs[1]["spec"]["template"]["spec"]["containers"][0][
        "resources"]["limits"]
    assert limits["nvidia.com/gpu"] == 8
    (job,) = job_manifest({"name": "p", "type": "gdmix_tpu_partition",
                           "depends_on": [], "command": ["true"]},
                          num_hosts=2)
    assert "completions" not in job["spec"]
    assert "nvidia.com/gpu" not in job["spec"]["template"]["spec"][
        "containers"][0]["resources"]["limits"]
    with pytest.raises(TypeError):   # TPU knobs are not the port's
        job_manifest({"name": "t", "type": "gdmix_tpu_train",
                      "depends_on": [], "command": ["true"]},
                     tpu_topology="2x2")


def test_launch_job_waits_raises_and_times_out(tmp_path):
    kubectl, state = _fake_kubectl(tmp_path, polls_until_done=3)
    manifest = tmp_path / "job.yaml"
    manifest.write_text("apiVersion: batch/v1\nkind: Job\n")
    obj = launch_job(str(manifest), "my-job", kubectl=kubectl,
                     poll_interval=0.01, timeout=60.0, delete_after=True)
    assert obj["status"]["conditions"][0]["type"] == "Complete"
    assert (state / "applied").read_text().strip() == str(manifest)
    assert (state / "deleted").read_text().strip() == str(manifest)
    (tmp_path / "f").mkdir()
    failing, _ = _fake_kubectl(tmp_path / "f", polls_until_done=1,
                               final="Failed")
    with pytest.raises(RuntimeError, match="failed"):
        launch_job(str(manifest), "bad-job", kubectl=failing,
                   poll_interval=0.01, timeout=60.0)
    (tmp_path / "s").mkdir()
    slow, _ = _fake_kubectl(tmp_path / "s", polls_until_done=10**9)
    with pytest.raises(RuntimeError, match="Timeout"):
        launch_job(str(manifest), "slow-job", kubectl=slow,
                   poll_interval=0.01, timeout=0.05)


def test_launch_dag_dependency_order(tmp_path):
    cfg = _write_cfg(tmp_path)
    out = str(tmp_path / "k8s")
    compile_kubernetes(cfg, out)
    kubectl, _ = _fake_kubectl(tmp_path, polls_until_done=1)
    order = launch_dag(out, kubectl=kubectl, poll_interval=0.01,
                       timeout_per_job=60.0)
    with open(os.path.join(out, "plan.json")) as f:
        plan = {j["name"]: j for j in json.load(f)["jobs"]}
    assert sorted(order) == sorted(plan)
    pos = {n: i for i, n in enumerate(order)}
    for name, j in plan.items():
        for dep in j["depends_on"]:
            assert pos[dep] < pos[name]


def test_workflow_main_kubernetes_mode(tmp_path):
    from gdmix_tpu_torch.workflow.main import main
    cfg = _write_cfg(tmp_path, extras={"k8s_config": {"namespace": "gdmix"}})
    out = str(tmp_path / "k8s")
    res = main(["--config_path", cfg, "--mode", "kubernetes",
                "--k8s_output_dir", out])
    assert len(res["jobs"]) == 8
    with open(os.path.join(out, "plan.json")) as f:
        assert json.load(f)["namespace"] == "gdmix"
    out2 = str(tmp_path / "k8s2")
    main(["--config_path", cfg, "--mode", "kubernetes", "--k8s_output_dir",
          out2, "--namespace", "other"])
    with open(os.path.join(out2, "plan.json")) as f:
        assert json.load(f)["namespace"] == "other"


def test_trainer_cli_joins_the_job(monkeypatch):
    """`python -m gdmix_tpu_torch.gdmix`, what the Job pods run, joins the
    job named by the environment before anything else, with the device
    asked for."""
    import gdmix_tpu_torch.gdmix as trainer
    calls = []
    monkeypatch.setattr(
        "gdmix_tpu_torch.workflow.distributed.maybe_initialize_distributed",
        lambda device: calls.append(device))
    with pytest.raises(Exception):
        # the params parsers fail on the empty flags, after the join
        trainer.run(["--action=train", "--device=cpu"])
    assert calls == ["cpu"]
