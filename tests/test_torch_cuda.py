"""The port on an NVIDIA GPU: the CUDA fused S2V layer against its plain
version, and the solve and service paths through it.  Every test here
needs a card and skips, saying so, without one.  The file imports neither
jax nor the JAX package, so it also runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import policy_from_numpy, policy_to_numpy
from repro_torch.core import (DENSE, PolicyConfig, init_policy,
                              init_solve_state, solve)
from repro_torch.core.graphs import erdos_renyi, random_graph_batch
from repro_torch.kernels import s2v_fused as ks
from repro_torch.serving import GraphSolverService

pytestmark = pytest.mark.cuda

# f32: the kernel and torch's matmul may sum in different orders;
# bf16: one bf16 rounding (2^-8 relative) of each matmul operand
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _layer_inputs(b, k, nl, n, seed=0):
    rng = np.random.default_rng(seed)
    rand = lambda s: (rng.random(s, np.float32) - 0.5).astype(np.float32)  # noqa: E731
    return [torch.from_numpy(x) for x in (
        rand((k, k)) * 0.2, rand((b, k, nl)),
        (rng.random((b, nl, n)) < 0.3).astype(np.float32), rand((b, k, n)))]


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_kernel_matches_plain_on_the_card(cuda, compute):
    """K of 5/8/16/32, ragged N (N % 4 != 0 takes the 4-byte copy path),
    Nl != N as on a row block."""
    for b, k, nl, n in ((2, 5, 33, 33), (2, 8, 37, 37), (1, 16, 130, 130),
                        (3, 32, 301, 301), (2, 32, 50, 72)):
        args = [t.to(cuda) for t in _layer_inputs(b, k, nl, n)]
        before = ks.fused_s2v_layer.launches
        out = ks.fused_s2v_layer(*args, compute)
        torch.cuda.synchronize()
        assert ks.fused_s2v_layer.launches == before + 1
        torch.testing.assert_close(
            out, ks.fused_s2v_layer_plain(*args, compute), **TOL[compute])


def test_wrapper_rejects_mixed_devices(cuda):
    t4, embed, adj, base = _layer_inputs(1, 8, 16, 16)
    with pytest.raises(ValueError, match="is on"):
        ks.fused_s2v_layer(t4.to(cuda), embed.to(cuda), adj.to(cuda), base)


def test_solve_on_the_card(cuda):
    """Valid covers, one kernel launch per evaluation, and first-evaluation
    scores within 1e-5 of the port on the CPU."""
    cfg = PolicyConfig(embed_dim=32)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cuda")
    adj = random_graph_batch("er", 64, 4, seed=1, rho=0.2)
    before = ks.fused_s2v_layer.launches
    res = solve(policy, adj, multi_node=True, device="cuda")
    assert ks.fused_s2v_layer.launches - before == res.policy_evals
    for g in range(adj.shape[0]):
        keep = res.solution[g] < 0.5
        assert adj[g][np.ix_(keep, keep)].sum() == 0
    cpu = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    with torch.no_grad():
        got = DENSE.scores(policy, init_solve_state(DENSE, adj, device="cuda"),
                           num_layers=2).cpu()
        want = DENSE.scores(cpu, init_solve_state(DENSE, adj, device="cpu"),
                            num_layers=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_service_on_the_card(cuda):
    cfg = PolicyConfig(embed_dim=16)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(1),
                         device="cuda")
    svc = GraphSolverService(policy, cfg, max_batch=2)
    svc.warmup([20, 40])
    adjs = [erdos_renyi(n, 0.3, seed=i) for i, n in enumerate((20, 40, 33))]
    sync = svc.serve(adjs)
    with svc:
        futures = [svc.submit_async(a) for a in adjs]
        responses = [f.result(timeout=120) for f in futures]
    assert svc.stats.compiles == 0
    for r, s, a in zip(responses, sync, adjs):
        assert (r.solution == s.solution).all()
        keep = r.solution < 0.5
        assert a[np.ix_(keep, keep)].sum() == 0
