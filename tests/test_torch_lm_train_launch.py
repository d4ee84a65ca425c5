"""The port's LM training launcher (``repro_torch.launch.train``) against
JAX's ``repro/launch/train.py``, and the train-step lockstep of the other
four reduced architectures (``test_torch_lm_train_step.check_lockstep``;
its bars).

Bars: on JAX's weights the launcher prints JAX's parameter line exactly
and its ``step`` lines' loss within rtol 1e-5 and grad norm within rtol
1e-5 (each beside the digits printed); resumed from its own checkpoint it
continues the run it saved bit for bit; ``--moe-mode alltoall`` without
a mesh trains as the dense run and as JAX's launcher does; the production
mesh raises without 256 ranks, naming ``torchrun`` (on a mesh of ranks the
launcher trains: tests/test_torch_lm_mesh_train.py), and under torchrun
it joins the process group first; without a card it raises unless asked
for the CPU."""
import contextlib
import dataclasses
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import train as jax_train
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train
from repro_torch.models import ModelCtx
from test_torch_lm_train_step import HERE, _np, check_lockstep

OTHERS = tuple(a for a in sorted(JAX_ARCHS) if a not in HERE)


@pytest.mark.parametrize("name", OTHERS)
def test_train_step_lockstep_with_jax(name):
    check_lockstep(name)


# ----------------------------------------------------------- launcher ------

def _jax_lines(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_train.main()
    return buf.getvalue().splitlines()


def _loss_lines(lines):
    """[(step, loss, gnorm)] of the ``step`` lines."""
    return [(int(ln.split()[1]), float(ln.split()[3]), float(ln.split()[5]))
            for ln in lines if ln.startswith("step ")]


def assert_lines_match(got, want):
    g, w = _loss_lines(got), _loss_lines(want)
    assert [s for s, _, _ in g] == [s for s, _, _ in w] and g
    for (_, gl, gn), (_, wl, wn) in zip(g, w):
        assert gl == pytest.approx(wl, rel=1e-5, abs=1e-4)   # 4 decimals
        assert gn == pytest.approx(wn, rel=1e-5, abs=1e-3)   # 3 decimals


@pytest.mark.parametrize("arch", ["granite-20b", "qwen2-moe-a2.7b"])
def test_launcher_prints_jax_loss_lines(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32"]
    want = _jax_lines(argv, monkeypatch)
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = lm_params_from_numpy(_np(jax_init_params(jax.random.key(0),
                                                      jcfg)), cfg,
                                  device="cpu")
    capsys.readouterr()
    out = train.main(argv + ["--device", "cpu"], params=params)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]                     # name, count, devices
    assert_lines_match(got, want)
    assert len(out["losses"]) == 3 and any(
        ln.startswith("3 steps in") for ln in got)


def test_launcher_alltoall_without_mesh_is_jax_dense(monkeypatch, capsys):
    """``--moe-mode alltoall`` with no mesh: JAX's launcher keeps the mode
    and its ``moe_apply`` runs the dense layer; the port's prints JAX's
    lines."""
    arch = "qwen2-moe-a2.7b"
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--moe-mode", "alltoall"]
    want = _jax_lines(argv, monkeypatch)
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = lm_params_from_numpy(_np(jax_init_params(jax.random.key(0),
                                                      jcfg)), cfg,
                                  device="cpu")
    capsys.readouterr()
    train.main(argv + ["--device", "cpu"], params=params)
    assert_lines_match(capsys.readouterr().out.splitlines(), want)


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """Three steps and a checkpoint, then two more from it: the same
    losses as five steps in one run (the stream is reseeded by the
    restored step, as JAX's launcher does)."""
    base = ["--arch", "rwkv6-7b", "--reduced", "--batch", "2", "--seq",
            "32", "--device", "cpu"]
    ckpt = ["--ckpt-dir", str(tmp_path)]
    first = train.main(base + ["--steps", "3"] + ckpt)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.npz")) == [
        "ckpt_00000003.npz"]
    capsys.readouterr()
    second = train.main(base + ["--steps", "2"] + ckpt)
    lines = capsys.readouterr().out.splitlines()
    assert "restored step 3" in lines
    assert [s for s, _, _ in _loss_lines(lines)] == [3, 4]
    assert int(second["opt"].step) == 5
    # step 3 from the restored state on the stream seeded 3
    from repro_torch.data import token_stream
    from repro_torch.models import make_train_step as mts
    batch = next(iter(token_stream(first["cfg"], 32, 2, steps=1, seed=3,
                                   device="cpu")))
    _, _, m = mts(first["cfg"], ModelCtx(remat=False, wkv_chunk=16))(
        first["params"], first["opt"], batch)
    assert float(m["loss"]) == second["losses"][0]


def test_production_mesh_joins_the_torchrun_group(monkeypatch):
    """With torchrun's variables set (a world of one rank here) the
    launcher joins that process group, gloo on the CPU, before it builds
    the production mesh, which then asks for its 256 ranks."""
    import socket
    import torch.distributed as dist
    from repro_torch.core.mesh import destroy_meshes
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for var, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port)).items():
        monkeypatch.setenv(var, value)
    assert not dist.is_initialized()
    try:
        with pytest.raises(RuntimeError, match="need 256 ranks.*have 1"):
            train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                        "--device", "cpu", "--production-mesh"])
        assert dist.is_initialized()
        assert (dist.get_backend(), dist.get_world_size()) == ("gloo", 1)
    finally:
        destroy_meshes()
    assert not dist.is_initialized()


def test_launcher_refusals():
    """The production mesh needs 256 ranks, as JAX's needs 256 devices
    (``main(mesh=)`` trains on a smaller one); without it ``--moe-mode
    alltoall`` and ``allreduce`` run the dense layer, as JAX's launcher
    does."""
    base = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="need 256 ranks.*torchrun"):
        train.main(base + ["--production-mesh"])
    run = ["--steps", "2", "--seq", "16"]
    dense = train.main(base + run)["losses"]
    assert train.main(base + ["--moe-mode", "alltoall"] + run)[
        "losses"] == dense
    out = train.main(base + ["--moe-mode", "allreduce"] + run)
    assert out["losses"] == dense and np.isfinite(out["losses"][0])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-20b", "--reduced"])
