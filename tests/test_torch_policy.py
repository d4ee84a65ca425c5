"""The port's policy evaluation (repro_torch.core.{s2v,qmodel,policy})
against the JAX package's on the CPU: the same JAX weights and graphs
through both, scores within 1e-5 at f32 for both lowerings."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.core import init_state as jax_init_state
from repro.core import policy_scores as jax_policy_scores
from repro.core import embed_full as jax_embed_full
from repro.core import random_graph_batch
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (PolicyConfig, init_policy, init_state,
                              policy_scores)
from repro_torch.core.mesh import single_axis
from repro_torch.core.s2v import embed_local

# f32 sums in another order than XLA's; bf16 rounds every matmul operand
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


def _pair(k, seed=0):
    params = jax_init_policy(jax.random.key(seed), JaxPolicyConfig(embed_dim=k))
    return params, policy_from_numpy(jax_to_numpy(params), device="cpu")


def _scores_both(params, policy, adj, **kw):
    js = jax_init_state(adj)
    # a partial solution, so the θ1 term is live
    sol = np.zeros(adj.shape[:2], np.float32)
    sol[:, ::5] = 1.0
    want = np.asarray(jax_policy_scores(params, js.adj, sol, js.candidate,
                                        **kw))
    st = init_state(adj, device="cpu")
    got = policy_scores(policy, st.adj, torch.from_numpy(sol), st.candidate,
                        **kw).detach().numpy()
    return got, want


@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("k", [8, 32])
def test_scores_match_jax_both_lowerings(num_layers, k):
    params, policy = _pair(k)
    adj = random_graph_batch("er", 36, 3, seed=1, rho=0.2)
    out = {}
    for kernel in ("fused", "xla"):
        got, want = _scores_both(params, policy, adj, num_layers=num_layers,
                                 kernel=kernel)
        np.testing.assert_allclose(got, want, **F32_TOL)
        out[kernel] = got
    np.testing.assert_allclose(out["fused"], out["xla"], **F32_TOL)


def test_bf16_scores_match_jax():
    params, policy = _pair(16, seed=2)
    adj = random_graph_batch("ba", 40, 2, seed=3)
    got, want = _scores_both(params, policy, adj, num_layers=2,
                             kernel="fused", compute="bf16")
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_unmasked_scores_and_candidates():
    params, policy = _pair(8)
    adj = random_graph_batch("er", 20, 2, seed=4, rho=0.3)
    adj[:, :, 15:] = 0.0
    adj[:, 15:, :] = 0.0
    got, want = _scores_both(params, policy, adj, num_layers=2,
                             masked=False)
    np.testing.assert_allclose(got, want, **F32_TOL)
    masked, _ = _scores_both(params, policy, adj, num_layers=2)
    assert (masked[:, 15:] == -1e9).all()


def test_config_validates_as_jax():
    PolicyConfig()
    for bad in (dict(kernel="cuda"), dict(compute="fp8"),
                dict(collectives="ring")):
        with pytest.raises(ValueError):
            PolicyConfig(**bad)
        with pytest.raises(ValueError):
            JaxPolicyConfig(**bad)
    assert [f.name for f in dataclasses.fields(PolicyConfig)] \
        == [f.name for f in dataclasses.fields(JaxPolicyConfig)]
    assert dataclasses.asdict(PolicyConfig()) \
        == dataclasses.asdict(JaxPolicyConfig())


def test_init_policy_is_seeded_and_keyed_like_jax():
    cfg = PolicyConfig(embed_dim=16)
    a = init_policy(cfg, generator=torch.Generator().manual_seed(5),
                    device="cpu")
    b = init_policy(cfg, generator=torch.Generator().manual_seed(5),
                    device="cpu")
    assert list(a.state_dict()) == ["em.theta1", "em.theta2", "em.theta3",
                                    "em.theta4", "q.theta5", "q.theta6",
                                    "q.theta7"]
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert a.state_dict()["q.theta7"].shape == (32,)


def test_sharded_embedding_is_not_ported():
    """The sharded embedding trains: on an axis of size 1 its gradients
    (B2's backward, the einsum's vjp, on the fused path) equal the
    single-device ones.  A bare axis name, with no mesh behind it, is
    refused."""
    _, policy = _pair(8)
    st = init_state(random_graph_batch("er", 12, 1, seed=0, rho=0.4),
                    device="cpu")
    with pytest.raises(TypeError, match="mesh axis"):
        embed_local(policy.em, st.adj, st.solution, num_layers=2,
                    axis="graph")
    grads = [torch.autograd.grad(embed_local(
        policy.em, st.adj, st.solution, num_layers=2, axis=axis).sum(),
        list(policy.em.parameters())) for axis in (None,
                                                   single_axis("graph"))]
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **F32_TOL)


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_embedding_gradients_match_jax(kernel):
    """The fused layer's backward (the plain composition's, as JAX's
    custom_vjp) and the xla chain's autograd: the gradients of the
    embeddings' sum with respect to θ1..θ4 within 1e-5 of jax.grad's."""
    params, policy = _pair(8, seed=1)
    adj = random_graph_batch("er", 24, 2, seed=2, rho=0.3)
    sol = np.zeros(adj.shape[:2], np.float32)
    sol[:, ::4] = 1.0
    want = jax.grad(lambda em: jax_embed_full(
        em, jnp.asarray(adj), jnp.asarray(sol), num_layers=3,
        kernel=kernel).sum())(params.em)
    emb = embed_local(policy.em, torch.from_numpy(adj), torch.from_numpy(sol),
                      num_layers=3, kernel=kernel)
    emb.sum().backward()
    for f in dataclasses.fields(want):
        np.testing.assert_allclose(
            getattr(policy.em, f.name).grad.numpy(),
            np.asarray(getattr(want, f.name)), **F32_TOL, err_msg=f.name)
