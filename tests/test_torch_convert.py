"""Weights and checkpoints carried between the JAX package and the port,
the launcher, and the port's package rules: it imports neither jax nor
anything of repro, and its entry points run on CUDA unless asked not to."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import load_policy as jax_load_policy
from repro.checkpoint import save_policy as jax_save_policy
from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.core import init_state as jax_init_state
from repro.core import policy_scores as jax_policy_scores
from repro.core import random_graph_batch
from repro_torch.checkpoint import load_policy, save_policy
from repro_torch.convert import policy_from_numpy, policy_to_numpy
from repro_torch.core import (DENSE, Agent, PolicyConfig, init_state,
                              policy_scores, train_agent)
from repro_torch.launch import solve_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + sorted((REPO / "examples").glob("pt_*.py")) + [REPO / "chip_smoke.py"]


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_policy(jax.random.key(4), JaxPolicyConfig(embed_dim=16))


def test_round_trip_is_exact(jax_params):
    arrays = jax_to_numpy(jax_params)
    back = policy_to_numpy(policy_from_numpy(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for key, arr in arrays.items():
        assert back[key].dtype == np.float32
        assert np.array_equal(back[key], arr), key


def test_bf16_weights_convert_to_their_f32_values(jax_params):
    arrays = jax_to_numpy(jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                       jax_params))
    policy = policy_from_numpy(arrays, device="cpu")
    for key, arr in policy_to_numpy(policy).items():
        assert np.array_equal(arr, arrays[key].astype(np.float32)), key


def test_bad_arrays_are_rejected(jax_params):
    arrays = jax_to_numpy(jax_params)
    with pytest.raises(KeyError):
        policy_from_numpy({k: v for k, v in arrays.items()
                           if k != "q.theta7"}, device="cpu")
    bad = dict(arrays, **{"q.theta7": arrays["q.theta7"][:-1]})
    with pytest.raises(ValueError, match="q.theta7"):
        policy_from_numpy(bad, device="cpu")


def test_jax_checkpoint_serves_in_the_port(tmp_path, jax_params):
    jax_save_policy(tmp_path, 7, jax_params)
    policy, step = load_policy(tmp_path, PolicyConfig(embed_dim=16),
                               device="cpu")
    assert step == 7
    adj = random_graph_batch("er", 24, 2, seed=0, rho=0.3)
    js = jax_init_state(adj)
    want = np.asarray(jax_policy_scores(jax_params, js.adj, js.solution,
                                        js.candidate, num_layers=2))
    st = init_state(adj, device="cpu")
    got = policy_scores(policy, st.adj, st.solution, st.candidate,
                        num_layers=2).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="embed_dim"):
        load_policy(tmp_path, PolicyConfig(embed_dim=8), device="cpu")


def test_port_checkpoint_loads_in_jax(tmp_path, jax_params):
    policy = policy_from_numpy(jax_to_numpy(jax_params), device="cpu")
    for step in (1, 2, 3, 4):
        save_policy(tmp_path, step, policy)
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 3      # keep=3
    restored, step = jax_load_policy(tmp_path, JaxPolicyConfig(embed_dim=16))
    assert step == 4
    for key, arr in jax_to_numpy(restored).items():
        assert np.array_equal(arr, jax_to_numpy(jax_params)[key]), key


def test_bf16_jax_checkpoint_loads(tmp_path, jax_params):
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jax_params)
    jax_save_policy(tmp_path, 1, bf)
    policy, _ = load_policy(tmp_path, PolicyConfig(embed_dim=16),
                            device="cpu")
    for key, arr in policy_to_numpy(policy).items():
        assert np.array_equal(arr, jax_to_numpy(bf)[key].astype(np.float32))


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    solve_serve.main(["--device", "cpu", "--requests", "4", "--sizes",
                      "12,20", "--embed-dim", "8", "--warmup"])
    out = capsys.readouterr().out
    assert "served 4 requests on cpu" in out
    assert "0 request-path first dispatches" in out
    # --rate drives the open-loop load generator and prints its report
    solve_serve.main(["--device", "cpu", "--rate", "50", "--requests", "3",
                      "--sizes", "12", "--embed-dim", "8"])
    assert "sync @ 50.0 rps offered: p50 " in capsys.readouterr().out


def test_entry_points_raise_without_cuda(tmp_path, jax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    jax_save_policy(tmp_path, 1, jax_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_policy(tmp_path, PolicyConfig(embed_dim=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_from_numpy(jax_to_numpy(jax_params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_serve.main(["--requests", "1"])
    adj = random_graph_batch("er", 10, 2, seed=0, rho=0.3)
    cfg = PolicyConfig(embed_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Agent(cfg, num_nodes=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DENSE.prepare_dataset(adj)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_agent(Agent(cfg, num_nodes=10), adj, episodes=1)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys; import repro_torch, repro_torch.core, "
            "repro_torch.serving, repro_torch.checkpoint, repro_torch.convert, "
            "repro_torch.optim, repro_torch.configs, repro_torch.models, "
            "repro_torch.data, repro_torch.launch.serve, "
            "repro_torch.launch.solve_serve, repro_torch.kernels.build, "
            "repro_torch.roofline.report, repro_torch.roofline.count, "
            "repro_torch.launch.dryrun, repro_torch.launch.dryrun_graph; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_sources_do_not_import_jax_or_repro(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(import repro\b|from repro[. ])", text, re.M)
