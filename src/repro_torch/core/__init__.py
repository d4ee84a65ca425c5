"""OpenGraphGym-MG core in PyTorch: structure2vec embedding (Alg. 2),
action evaluation (Alg. 3) and the adaptive top-d solve (Alg. 4) on the
dense graph representation."""
from .graphs import (GraphState, init_state, residual_adjacency,
                     erdos_renyi, barabasi_albert, social_like,
                     random_graph_batch)
from .graphrep import GraphRep, DenseRep, DENSE, get_rep
from .policy import PolicyConfig, Policy, init_policy, policy_scores
from .s2v import S2V, init_s2v, embed_local
from .qmodel import QModel, init_q, scores_local
from .engine import get_solve_step
from .inference import (solve, solve_with_config, adaptive_d, select_top_d,
                        apply_selection, init_solve_state, InferenceResult)
from . import env
