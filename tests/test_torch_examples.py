"""The port's example scripts (``examples/pt_*.py``) run in-process through
their ``main(argv)`` on the CPU at small sizes.

Bars: each prints its lines; every solution it returns is feasible by
the env's checkers (``repro_torch.core.env``); ``pt_spatial_inference``'s
mesh scores (4 gloo ranks, a (2, 2) mesh) are within 1e-5 of one
device's on both representations and its collective lines say by what
the mesh's counts differ from the paper's model; ``pt_serve_batched``
on JAX's weights generates the tokens ``examples/serve_batched.py``
prints for every request; ``pt_train_lm`` on JAX's weights prints
``examples/train_lm.py``'s losses (rtol 1e-5) and ``DECREASED``; run
without
``--device``, every script asks for the card and raises without one."""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import env

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
SCRIPTS = ("pt_quickstart", "pt_train_mvc_agent", "pt_solve_service",
           "pt_spatial_inference", "pt_serve_batched", "pt_train_lm")


def _script(name):
    """The example module; its directory on the path, so that ranks it
    spawns import it by name."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def _feasible(problem, adj, solution) -> bool:
    return bool(env.checker(problem)(torch.as_tensor(adj),
                                     torch.as_tensor(solution)).all())


@pytest.mark.parametrize("name", SCRIPTS)
def test_each_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _script(name).main([])


def test_quickstart(capsys):
    out = _script("pt_quickstart").main([
        "--device", "cpu", "--steps", "30", "--nodes", "12",
        "--embed-dim", "8", "--minibatch", "8"])
    text = capsys.readouterr().out
    for line in ("before training: ratio =", "after 30 steps : ratio =",
                 "RL sizes     :", "exact optima :", "policy evals :"):
        assert line in text
    for rep in ("dense", "sparse"):
        assert _feasible("mvc", out["test"], out[rep].solution)
    assert (out["dense"].sizes >= out["refs"]).all()


SMALL_TRAIN = ["--device", "cpu", "--steps", "12", "--nodes", "14",
               "--embed-dim", "8", "--tau", "2", "--minibatch", "8",
               "--eval-every", "6", "--graphs", "4"]


@pytest.mark.parametrize("problem,rep,engine", [
    ("mvc", "dense", "device"), ("maxcut", "sparse", "device"),
    ("mis", "csr", "host"), ("mds", "dense", "host")])
def test_train_mvc_agent(problem, rep, engine, tmp_path, capsys):
    out = _script("pt_train_mvc_agent").main(
        SMALL_TRAIN + ["--problem", problem, "--rep", rep, "--engine",
                       engine, "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert f"training {problem} on 4 er(14) graphs" in text
    assert "ratio-vs-ref" in text and "done in" in text
    assert "policy params saved to" in text
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 1
    assert out["step_count"] > 0 and np.isfinite(out["losses"][-1])
    assert _feasible(problem, out["test"], out["solution"])
    if problem == "maxcut":
        assert "RL best-trajectory cut" in text and (out["cuts"] >= 0).all()
    else:
        assert f"RL (adaptive) mean |{problem.upper()}|" in text


def test_train_mvc_agent_on_a_mesh_it_spawns(capsys):
    """``--spatial 2,1`` starts two gloo ranks; rank 0's lines print, and
    its solution is feasible."""
    out = _script("pt_train_mvc_agent").main(
        SMALL_TRAIN + ["--spatial", "2,1", "--rep", "csr"])
    text = capsys.readouterr().out
    assert "on mesh (2, 1) rank 0 of 2" in text
    assert out["ranks"] == 2 and out["step_count"] > 0
    assert _feasible("mvc", out["test"], out["solution"])


def test_train_mvc_agent_refuses_gspmd_on_a_mesh():
    """The port has no GSPMD path: ``--collectives gspmd`` on a mesh is
    refused before any rank starts work."""
    with pytest.raises(RuntimeError, match="no counterpart"):
        _script("pt_train_mvc_agent").main(
            SMALL_TRAIN + ["--spatial", "1,2", "--collectives", "gspmd",
                           "--steps", "1"])


@pytest.mark.parametrize("mode,rep", [("sync", "dense"), ("async", "csr")])
def test_solve_service(mode, rep, tmp_path, capsys):
    out = _script("pt_solve_service").main([
        "--device", "cpu", "--steps", "10", "--requests", "4",
        "--sizes", "12,20", "--mode", mode, "--rep", rep,
        "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "checkpoint:" in text and "4 requests" in text
    assert len(out["responses"]) == 4
    for adj, r in zip(out["adjs"], out["responses"]):
        assert len(r.solution) == adj.shape[0]
        assert _feasible("mvc", adj, r.solution)
    if mode == "async":
        assert "request-path first dispatches == 0" in text
        assert "4/4 on time" in text
        assert out["stats"].compiles == 0


def test_spatial_inference_on_four_ranks(capsys):
    out = _script("pt_spatial_inference").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["mesh"] == (2, 2) and len(out["ranks"]) == 4
    for rep in ("dense", "sparse"):
        assert out["max_abs_diff"][rep] <= 1e-5
        assert f"[{rep:6s}] mesh scores vs one device" in text
    # the paper's model beside the counts: layer 0 elided, each rank's own
    # operand of the score all-gather, no gradient in an evaluation
    lines = "\n".join(out["collective_lines"])
    assert "counted 1 = 8192 B (+8192 B: layer 0's input" in lines
    assert "counted 1 = 128 B (x2: Mesh.traffic counts" in lines
    assert "counted 0 (an evaluation takes no gradient)" in lines
    assert "per-rank adjacency bytes" in text


@pytest.mark.parametrize("arch", ["llama3-405b", "gemma3-4b"])
def test_serve_batched_generates_jax_tokens(arch, monkeypatch, capsys):
    """The same prompts (numpy seed 0) and loop as JAX's example, on JAX's
    seed-0 weights carried across: the same request lines."""
    import dataclasses

    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.models import init_params as jax_init_params
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_numpy
    argv = ["--arch", arch, "--gen-tokens", "6"]
    monkeypatch.setattr(sys, "argv", ["serve_batched.py"] + argv)
    _script("serve_batched").main()
    want = capsys.readouterr().out.splitlines()
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32")
    params = lm_params_from_numpy(
        jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg)),
        dataclasses.replace(get_arch(arch).reduced(), dtype="float32"),
        device="cpu")
    out = _script("pt_serve_batched").main(argv + ["--device", "cpu"],
                                           params=params)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]                      # name and params
    reqs = [ln for ln in got if ln.startswith("  req")]
    assert len(reqs) == 4
    assert reqs == [ln for ln in want if ln.startswith("  req")]
    assert got[1].startswith("served 4 requests, ")
    # a row generates from its prompt's last token to the loop's end
    maxlen = max(len(p) for p in out["prompts"])
    assert [len(o) for o in out["outputs"]] == [maxlen + 6 + 1] * 4


def test_train_lm_decreases_as_jax_does(monkeypatch, capsys):
    """The default run (gemma3-4b reduced, a 2048-token vocabulary, 12
    steps) on JAX's seed-0 weights carried across: the losses JAX's
    example prints and its last line."""
    import dataclasses

    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.models import init_params as jax_init_params
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_numpy
    monkeypatch.setattr(sys, "argv", ["train_lm.py"])
    _script("train_lm").main()
    want = capsys.readouterr().out.splitlines()
    jcfg = dataclasses.replace(jax_get_arch("gemma3-4b").reduced(),
                               vocab_size=2048, dtype="float32")
    params = lm_params_from_numpy(
        jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg)),
        dataclasses.replace(get_arch("gemma3-4b").reduced(),
                            vocab_size=2048, dtype="float32"), device="cpu")
    out = _script("pt_train_lm").main(["--device", "cpu"], params=params)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]                      # name, params, layers

    def losses(lines):
        return [float(ln.split()[3]) for ln in lines
                if ln.startswith("step ")]
    assert len(losses(got)) == len(losses(want)) == 12
    np.testing.assert_allclose(losses(got), losses(want), rtol=1e-5,
                               atol=1e-4)         # printed to 4 decimals
    np.testing.assert_allclose(out["losses"][0], losses(want)[0], rtol=1e-5)
    assert got[-1].endswith("(DECREASED)") and want[-1].endswith(
        "(DECREASED)")
    first, last = got[-1].split()[1], got[-1].split()[3]
    assert (first, last) == (want[-1].split()[1], want[-1].split()[3])
