"""OpenGraphGym-MG core in PyTorch: structure2vec embedding (Alg. 2),
action evaluation (Alg. 3) and the adaptive top-d solve (Alg. 4) on the
dense, padded-sparse and CSR graph representations, on one device or on
a 2-D (data, graph) mesh of torch.distributed ranks; and training (Alg.
5, compressed replay §4.4) on the three representations, through the
fused step on one device or on the mesh and through the host loop on one
device; the problem suite (MVC on the mesh too; MaxCut, MIS and
MDS on one device) and its classical baselines (``solvers``); and
neighbour-sampled training on one resident CSR graph (``sampling``)."""
from .graphs import (GraphState, SparseGraphBatch, SparseGraphState,
                     CsrGraphBatch, CsrGraphState, init_state,
                     residual_adjacency, residual_edge_mask,
                     sparse_batch_from_dense, sparse_init_state, csr_row_ids,
                     csr_segment_sum, csr_residual_edge_mask,
                     csr_batch_from_dense, csr_batch_from_arrays,
                     csr_batch_to_dense, csr_init_state,
                     barabasi_albert_edges, csr_from_edges, cached_ba_csr,
                     erdos_renyi, barabasi_albert, social_like,
                     random_graph_batch)
from .graphrep import (GraphRep, DenseRep, SparseRep, CsrRep, DENSE, SPARSE,
                       CSR, get_rep, rep_for_state, rep_names)
from .policy import (PolicyConfig, Policy, init_policy, num_params,
                     policy_scores)
from .s2v import S2V, init_s2v, embed_local, embed_full
from .s2v_sparse import embed_sparse, sparse_policy_scores, sparse_state_bytes
from .s2v_csr import embed_csr, csr_policy_scores, csr_state_bytes
from .qmodel import QModel, init_q, scores_local
from .agent import (Agent, candidate_mask, greedy_action_state, max_q_state,
                    greedy_action, max_q)
from .replay import (ReplayBuffer, DeviceReplay, device_replay_init,
                     device_replay_push, device_replay_sample,
                     device_replay_at, device_replay_from_host,
                     tuples_to_graphs)
from .engine import (EngineState, TrainDraws, draw_train_step, engine_init,
                     get_train_step, get_solve_step, sync_to_agent)
from .training import train_agent, evaluate_quality, TrainLog
from .sampling import NeighborSampler, SampledSubgraph
from .inference import (solve, solve_with_config, adaptive_d, select_top_d,
                        apply_selection, init_solve_state, solve_step,
                        best_trajectory_cut, InferenceResult)
from .mesh import (DATA, GRAPH, make_mesh, mesh_from_spec, mesh_shape,
                   normalize_spatial, is_multi, parse_spatial, shard_state,
                   shard_batch, shard_dataset, spawn_mesh, per_device_bytes,
                   sparse_per_device_bytes, csr_per_device_bytes,
                   minibatch_operand_bytes)
from .spatial import (make_graph_mesh, spatial_scores_fn,
                      sparse_spatial_scores_fn, spatial_solve_scores_fn,
                      shard_graph_arrays, shard_sparse_arrays,
                      manual_train_minibatch_fn, tile_state_from_tuples)
from . import env, solvers
