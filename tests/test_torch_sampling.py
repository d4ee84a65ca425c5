"""The port's neighbour sampler (``repro_torch.core.sampling``) against the
JAX package's on the CPU: the same resident graph and seeds through both.

Bars: subgraphs, node maps, seed batches and training batches bit for bit
JAX's (the same numpy draws); the sampler contract of
``tests/test_csr.py``'s sampler tests; the sampled batch a CSR dataset the
port takes; the fused train step on a sampled dataset in lockstep with
JAX's (identical actions, losses and parameters within ``STEP_TOL``)."""
import numpy as np
import pytest
import torch

from repro.core.graphs import barabasi_albert_edges as jax_ba_edges
from repro.core.graphs import csr_from_edges as jax_csr_from_edges
from repro.core.sampling import NeighborSampler as JaxSampler
from repro_torch.convert import policy_to_numpy
from repro_torch.core import (CSR, Agent, CsrGraphBatch, NeighborSampler,
                              PolicyConfig, SampledSubgraph, train_agent)
from repro_torch.core.graphs import csr_batch_to_dense, symmetric_topology
from test_torch_train import _assert_lockstep, _lockstep

FIELDS = ("indptr", "indices", "edge_mask")


@pytest.fixture(scope="module")
def resident():
    """tests/test_csr.py's resident graph: BA(1500, d=4) as CSR arrays."""
    n = 1500
    src, dst = jax_ba_edges(n, d=4, seed=0)
    return (n,) + jax_csr_from_edges(n, src, dst)


def _pair(resident, **kw):
    _, ip, ix = resident
    return JaxSampler(ip, ix, **kw), NeighborSampler(ip, ix, **kw)


def _assert_same_batch(jax_batch, batch):
    assert isinstance(batch, CsrGraphBatch)
    for f in FIELDS:
        want, got = np.asarray(getattr(jax_batch, f)), getattr(batch, f)
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _assert_same_subgraph(want, got):
    assert isinstance(got, SampledSubgraph)
    _assert_same_batch(want.graph, got.graph)
    np.testing.assert_array_equal(got.node_map, want.node_map)
    assert got.node_map.dtype == want.node_map.dtype
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert got.num_nodes == want.num_nodes


# (batch_size, fanouts, seed, node_budget, edge_budget, seeds): the
# defaults (no truncation) at one, two and three hops; a node budget that
# cuts the second hop, and one that keeps only the seeds and a few more
SAMPLES = [
    (6, (5, 3), 2, None, None, (3, 77, 400)),
    (1, (4,), 5, None, None, (10,)),
    (4, (4, 3), 0, None, None, (0, 1, 2, 1499)),
    (8, (3, 2, 2), 7, None, None, (5, 50, 500, 900, 1200, 1300, 7, 8)),
    (6, (5, 3), 2, 20, None, (3, 77, 400)),
    (4, (8, 4), 1, 6, None, (11, 12, 13, 14)),
]


@pytest.mark.parametrize("bs,fanouts,seed,nb,eb,seeds", SAMPLES)
def test_sample_equals_jax_bit_for_bit(resident, bs, fanouts, seed, nb, eb,
                                       seeds):
    kw = dict(batch_size=bs, fanouts=fanouts, seed=seed, node_budget=nb,
              edge_budget=eb)
    js, ps = _pair(resident, **kw)
    assert (ps.node_budget, ps.edge_budget) == (js.node_budget,
                                                js.edge_budget)
    seeds = np.array(seeds)
    got = ps.sample(seeds, device="cpu")
    _assert_same_subgraph(js.sample(seeds), got)
    if nb is not None:                       # the budget truncated nodes
        assert got.num_nodes == nb
        np.testing.assert_array_equal(got.node_map[:len(seeds)], seeds)


@pytest.mark.parametrize("bs,fanouts,seed", [(64, (4,), 0), (400, (5, 3), 3),
                                             (7, (2, 2), 9)])
def test_seed_batches_equal_jax_over_two_epochs(resident, bs, fanouts, seed):
    js, ps = _pair(resident, batch_size=bs, fanouts=fanouts, seed=seed)
    for epoch in (0, 1):
        want = list(js.seed_batches(epoch))
        got = list(ps.seed_batches(epoch))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bs,fanouts,graphs,epoch", [
    (4, (4, 3), 5, 0),
    # 4 seed batches an epoch: six graphs go on into the next epoch
    (400, (2,), 6, 1),
    (6, (5, 3), 3, 2),
])
def test_training_batch_equals_jax_bit_for_bit(resident, bs, fanouts, graphs,
                                               epoch):
    js, ps = _pair(resident, batch_size=bs, fanouts=fanouts, seed=1)
    jbatch, jmaps = js.training_batch(graphs, epoch)
    batch, maps = ps.training_batch(graphs, epoch, device="cpu")
    _assert_same_batch(jbatch, batch)
    np.testing.assert_array_equal(maps, jmaps)
    subs = list(ps.subgraphs(epoch, device="cpu"))[:graphs]
    for i, sg in enumerate(subs):
        for f in FIELDS:
            assert torch.equal(getattr(batch, f)[i], getattr(sg.graph, f)[0])


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_an_edge_budget_too_small_raises_as_jax(resident):
    kw = dict(batch_size=6, fanouts=(5, 3), seed=2, edge_budget=10)
    js, ps = _pair(resident, **kw)
    seeds = np.array([3, 77, 400])
    msg = _error(lambda: js.sample(seeds))
    assert "edge_budget=10" in msg
    assert _error(lambda: ps.sample(seeds, device="cpu")) == msg


@pytest.mark.parametrize("kw", [dict(batch_size=4, fanouts=()),
                                dict(batch_size=4, fanouts=(3, 0)),
                                dict(batch_size=4, fanouts=(-1,)),
                                dict(batch_size=8, node_budget=5)],
                         ids=["no_hops", "zero_fanout", "negative_fanout",
                              "node_budget_below_seeds"])
def test_bad_arguments_raise_as_jax(resident, kw):
    _, ip, ix = resident
    assert _error(lambda: NeighborSampler(ip, ix, **kw)) == _error(
        lambda: JaxSampler(ip, ix, **kw))


def test_the_batch_defaults_to_the_card(resident):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    _, ip, ix = resident
    ps = NeighborSampler(ip, ix, batch_size=2, fanouts=(2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ps.sample(np.array([0, 1]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ps.training_batch(1)


# -- tests/test_csr.py's sampler contract, on the port ------------------------

def test_sampler_shapes_and_determinism(resident):
    n, ip, ix = resident
    s = NeighborSampler(ip, ix, batch_size=6, fanouts=(5, 3), seed=2)
    seeds = np.array([3, 77, 400])
    a, b = s.sample(seeds, device="cpu"), s.sample(seeds, device="cpu")
    assert a.graph.indptr.shape == (1, s.node_budget + 1)
    assert a.graph.indices.shape == (1, s.edge_budget)
    assert a.node_map.shape == (s.node_budget,)
    assert torch.equal(a.graph.indices, b.graph.indices)
    np.testing.assert_array_equal(a.node_map, b.node_map)
    np.testing.assert_array_equal(a.node_map[:3], seeds)


def test_sampler_epoch_covers_every_node_once(resident):
    n, ip, ix = resident
    s = NeighborSampler(ip, ix, batch_size=64, fanouts=(4,), seed=0)
    seeds = np.concatenate(list(s.seed_batches(epoch=1)))
    assert sorted(seeds.tolist()) == list(range(n))
    seeds0 = np.concatenate(list(s.seed_batches(epoch=0)))
    assert not np.array_equal(seeds, seeds0)


def test_sampler_subgraph_edges_exist_and_fanout_capped(resident):
    n, ip, ix = resident
    f1 = 4
    s = NeighborSampler(ip, ix, batch_size=1, fanouts=(f1,), seed=5)
    sg = s.sample(np.array([10]), device="cpu")
    dense = csr_batch_to_dense(sg.graph)[0]
    assert np.array_equal(dense, dense.T) and np.trace(dense) == 0
    assert dense[0].sum() <= f1
    full = np.zeros((n, n), bool)
    rid = np.repeat(np.arange(n), np.diff(ip))
    full[rid, ix] = True
    li, lj = np.nonzero(dense[:sg.num_nodes, :sg.num_nodes])
    assert full[sg.node_map[li], sg.node_map[lj]].all()
    assert dense[sg.num_nodes:, :].sum() == 0
    assert (sg.node_map[sg.num_nodes:] == -1).all()


def test_sampler_training_batch_stacks(resident):
    n, ip, ix = resident
    s = NeighborSampler(ip, ix, batch_size=4, fanouts=(4, 3), seed=1)
    batch, maps = s.training_batch(5, device="cpu")
    assert isinstance(batch, CsrGraphBatch)
    assert batch.indptr.shape == (5, s.node_budget + 1)
    assert batch.indices.shape == (5, s.edge_budget)
    assert maps.shape == (5, s.node_budget)


def test_sampled_batch_is_a_symmetric_csr_dataset(resident):
    """CSR.prepare_dataset takes the stacked batch as it is (its symmetry
    check passes: csr_from_edges mirrors every sampled edge), and the
    padding slots carry the sentinel and no mask."""
    _, ip, ix = resident
    s = NeighborSampler(ip, ix, batch_size=6, fanouts=(5, 3), seed=4)
    batch, _ = s.training_batch(4, device="cpu")
    assert symmetric_topology(batch)
    source = CSR.prepare_dataset(batch, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(source, f), getattr(batch, f))
    assert CSR.dataset_shape(source) == (4, s.node_budget)
    live = batch.edge_mask
    assert (batch.indices[~live] == s.node_budget).all()
    assert torch.equal(live.sum(1), batch.indptr[:, -1].long())


# -- the fused train step on a sampled dataset, in lockstep with JAX's --------

def _sampled_source(resident):
    js, ps = _pair(resident, batch_size=4, fanouts=(4, 3), seed=0)
    return js.training_batch(6)[0], ps.training_batch(6, device="cpu")[0]


@pytest.mark.parametrize("problem,mode,eps", [
    ("mvc", "stored", 0.0), ("mvc", "fresh", 0.5), ("maxcut", "stored", 0.0),
    ("mis", "stored", 0.0), ("mds", "stored", 0.0)])
def test_fused_step_on_a_sampled_source_matches_jax(resident, problem, mode,
                                                    eps):
    out, want, got = _lockstep(mode, eps, rep="csr", problem=problem,
                               gi=(0, 3), source=_sampled_source(resident))
    if eps:
        assert out["explored"] >= 4
    _assert_lockstep(out, want, got)


def test_sampler_train_smoke(resident):
    """tests/test_csr.py's train smoke through the user's entry point:
    ``train_agent`` on a sampled CSR dataset, on the CPU."""
    _, ip, ix = resident
    s = NeighborSampler(ip, ix, batch_size=4, fanouts=(4, 3), seed=0)
    source, _maps = s.training_batch(6, device="cpu")
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                       replay_capacity=64, learning_rate=1e-3,
                       graph_rep="csr")
    agent = Agent(cfg, num_nodes=source.num_nodes, device="cpu")
    before = {k: v.copy() for k, v in policy_to_numpy(agent.params).items()}
    log = train_agent(agent, source, episodes=1, max_steps=5, tau=2,
                      batch_graphs=4, eval_every=10 ** 9, seed=0)
    losses = np.asarray(log.losses)
    assert len(losses) == 5 and np.isfinite(losses[-1])
    assert agent.step_count == int(np.isfinite(losses).sum()) > 0
    assert any(not np.array_equal(v, before[k])
               for k, v in policy_to_numpy(agent.params).items())
