"""The port's dry run (``python -m repro_torch.launch.dryrun`` and
``repro_torch.launch.dryrun_cnn``) in subprocesses — each must own its
process, whose default process group is the fake one of 256 or 512
ranks — with tests/test_dryrun.py's two cases and the CNN's pair:

(a) mamba2-370m ``train_4k`` on (16, 16): chips 256, FLOPs per device
    > 0, a dominant term, and a footprint under the H100's 80 GB (the
    JAX test holds its TPU's HBM);
(b) mamba2-370m ``decode_32k`` on (2, 16, 16): chips 512, mesh
    "2x16x16";
(c) ``dryrun_cnn`` on cifar_cnn_150_800 (the one paper size whose C2
    kernels divide the 16-way model axis) at batch 1024: one record per
    mode, gather's all-gather bytes above megatron's (the paper's
    gathered feature maps against channel-sharded ones).

Every record carries the JAX record's keys.  The fake tensors sit on
the CPU here (``--device cpu``); on the card, chip_smoke.py runs the
same CLI on ``cuda``.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_KEYS = {"arch_id", "shape", "mesh", "tp_mode", "chips", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "collective_breakdown",
            "compute_s", "memory_s", "collective_s", "model_flops",
            "bytes_per_device_peak", "dominant", "useful_flops_ratio", "mfu_upper_bound",
            "remat", "moe_dispatch", "compile_s", "memory_analysis", "hbm_bytes_per_device"}
H100_BYTES = 80e9


def _run(module, args, out, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", module, *args, "--device", "cpu",
                        "--out", str(out)],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-8000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_dryrun_subprocess_single_pair(tmp_path):
    (rec,) = _run("repro_torch.launch.dryrun", ["--arch", "mamba2-370m", "--shape",
                                                "train_4k", "--mesh", "single"],
                  tmp_path / "rec.jsonl")
    assert JAX_KEYS <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["hbm_bytes_per_device"] < H100_BYTES
    assert rec["collective_bytes_per_device"] > 0  # megatron shards over model
    assert 0 < rec["useful_flops_ratio"] < 1


def test_dryrun_subprocess_multipod(tmp_path):
    (rec,) = _run("repro_torch.launch.dryrun", ["--arch", "mamba2-370m", "--shape",
                                                "decode_32k", "--mesh", "multi"],
                  tmp_path / "rec.jsonl")
    assert JAX_KEYS <= set(rec)
    assert rec["chips"] == 512
    assert rec["mesh"] == "2x16x16"
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] < H100_BYTES


def test_dryrun_cnn_gather_gathers_more_than_megatron(tmp_path):
    recs = _run("repro_torch.launch.dryrun_cnn", ["--arch", "cifar_cnn_150_800"],
                tmp_path / "cnn.jsonl")
    by_mode = {r["tp_mode"]: r for r in recs}
    assert sorted(by_mode) == ["gather", "megatron"]
    for r in recs:
        assert r["chips"] == 256 and r["shape"] == "train_b1024" and r["flops_per_device"] > 0
    assert (by_mode["gather"]["collective_breakdown"]["all-gather"]
            > by_mode["megatron"]["collective_breakdown"]["all-gather"] > 0)


def test_dryrun_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a host without a card")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-370m", "--shape", "train_4k"],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "needs a CUDA card" in r.stderr


def test_mesh_modules_load_no_jax_at_run_time():
    """The mesh layer's modules, as tests/test_torch_imports.py holds the
    earlier entry points: imported, they load neither jax nor ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.sharding, repro_torch.sharding.local\n"
        "import repro_torch.roofline, repro_torch.roofline.report\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.dryrun_cnn, repro_torch.core.conv_shard\n"
        "import repro_torch.core.profiling, repro_torch.configs.input_specs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
