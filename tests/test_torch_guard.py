"""Guards around the port: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU silently, a CPU call launches
no kernel, the kernel wrappers refuse devices they do not serve, and a
failed kernel build raises."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.bea_batched import bea_batched
from repro_torch.kernels.bea_fused import bea_dense
from repro_torch.kernels.flash_attention import mha_flash
from repro_torch.launch import serve

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    script = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "repro")

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked import " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO / "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(REPO / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        assert set("repro_torch.secagg." + m for m in
                   ("field", "dp", "masking", "protocol")) <= set(names)
        assert set(["repro_torch.models.moe",
                    "repro_torch.configs.granite_moe_1b_a400m",
                    "repro_torch.configs.kimi_k2_1t_a32b",
                    "repro_torch.models.ssm",
                    "repro_torch.configs.minicpm_2b",
                    "repro_torch.configs.mamba2_780m",
                    "repro_torch.models.plan",
                    "repro_torch.configs.zamba2_1p2b",
                    "repro_torch.configs.internvl2_1b"]) <= set(names)
        assert set("repro_torch.fedsim." + m for m in
                   ("cohort", "runner", "fused")) <= set(names)
        assert set("repro_torch.obs." + m for m in
                   ("trace", "metrics", "sketch", "record", "export",
                    "health", "profile", "regress", "report", "live",
                    "top", "__main__")) <= set(names)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 73          # every module was imported


def test_untraced_run_is_a_plain_history_and_emits_nothing():
    """Tracing off (the default), a run's history is the recorder with
    plain keys only, and the null tracer holds no event."""
    from repro_torch import obs
    from repro_torch.configs.distilbert import MINI
    from repro_torch.data.synthetic import make_classification
    from repro_torch.federated.baselines import FedLoRA
    from repro_torch.federated.partition import iid_partition
    from repro_torch.federated.server import FedConfig, run_federated
    from repro_torch.models import Model

    obs.disable()
    cfg = MINI.with_(n_layers=1, layer_pattern=("attn",))
    train = make_classification(96, 4, cfg.vocab_size, 16, seed=1)
    h = run_federated(Model(cfg, peft="lora"), FedLoRA(),
                      iid_partition(train.labels, 3, seed=0), train, train,
                      FedConfig(rounds=2, clients_per_round=2, batch_size=16,
                                max_local_batches=1, eval_batches=1,
                                eval_every=2), device="cpu")
    assert isinstance(h, dict) and type(h).__name__ == "RunRecorder"
    assert set(h) == {"rounds", "acc", "comm_gb", "sim_time_s",
                      "secagg_rounds", "dp_eps", "final_acc", "wall_s",
                      "base", "trainable", "masks"}
    assert len(h["rounds"]) == 2 and h["comm_gb"] > 0
    assert obs.get_tracer() is obs.NULL_TRACER
    assert obs.get_tracer().events() == [] and obs.close() == []


def test_build_engine_defaults_to_cuda_and_never_falls_back():
    cfg = get_config("qwen2_0p5b", smoke=True)
    if torch.cuda.is_available():
        eng = serve.build_engine(cfg, n_slots=1, max_seq=8)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.build_engine(cfg, n_slots=1, max_seq=8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.build_engine(cfg, n_slots=1, max_seq=8, device="cuda")


def test_build_engine_on_cpu_serves_and_launches_nothing():
    cfg = get_config("qwen2_0p5b", smoke=True)
    eng = serve.build_engine(cfg, n_slots=2, max_seq=20, n_tenants=2,
                             device="cpu")
    assert eng.device.type == "cpu"
    assert eng.registry.ids() == ["client0", "client1"]
    K.reset_launches()
    reqs = serve.serve_requests(eng, [list(range(1, 12)), [5, 6, 7]],
                                ["client0", "client1"], 4)
    assert [len(r.out) for r in reqs] == [4, 4]
    assert all(v == 0 for v in K.launch_counts().values())


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "3", "--prompt-len", "9",
                "--gen", "3", "--tenants", "2"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "9 tokens" in out


def test_wrappers_refuse_devices_they_do_not_serve():
    x = torch.zeros(2, 4, device="meta")
    w = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bea_dense(x, w, torch.zeros(1, 4, device="meta"),
                  torch.zeros(3, 1, device="meta"),
                  torch.zeros(1, device="meta"),
                  torch.ones(1, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        bea_batched(x, w, torch.zeros(1, 1, 4, device="meta"),
                    torch.zeros(1, 3, 1, device="meta"),
                    torch.zeros(1, 1, device="meta"),
                    torch.ones(1, 1, dtype=torch.bool, device="meta"),
                    torch.zeros(2, dtype=torch.int32, device="meta"))
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mha_flash(q, q[:, :, :1], q[:, :, :1])


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/false")
    with pytest.raises(_build.BuildError, match="nvcc failed"):
        _build.build(("bea_fused",))
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_targets_hash_their_source():
    names = {_build.target(n).name for n in _build.SOURCES}
    assert len(names) == 3
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert _build.target("bea_fused").parent == REPO / "build"
