"""The paper's own architecture (Table I), port of
``repro.configs.paper_gnn``: consistent encode-process-decode GNN, 'small'
(N_H=8, M=4, 2 MLP hidden) and 'large' (N_H=32, M=4, 5 hidden), trained on
Taylor-Green-vortex velocity autoencoding over SEM meshes.  The smoke
config (N_H=4, one MLP hidden layer) runs kernels 1 and 2 at a width the
tuned pair does not take (``csrc/nmp_any.cu``)."""
from repro_torch.core.gnn import GNNConfig

ARCH_ID = "paper-gnn"
FAMILY = "gnn"


def config() -> GNNConfig:
    return GNNConfig.large()


def small_config() -> GNNConfig:
    return GNNConfig.small()


def smoke_config() -> GNNConfig:
    return GNNConfig(hidden=4, n_mp_layers=2, mlp_hidden_layers=1)
