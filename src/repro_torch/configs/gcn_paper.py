"""The paper's own GCN configuration (§4.1): 2-layer GCN, 1000 hidden units,
ReLU, cross-entropy, ν = ρ = 1e-3 (Computers) / 1e-4 (Photo)."""
from repro_torch.core.gcn import GCNConfig
from repro_torch.core.subproblems import ADMMConfig


def config(dataset: str = "amazon_computers"):
    feats = {"amazon_computers": 767, "amazon_photo": 745,
             "amazon_computers_mini": 767, "amazon_photo_mini": 745}[dataset]
    classes = {"amazon_computers": 10, "amazon_photo": 8,
               "amazon_computers_mini": 10, "amazon_photo_mini": 8}[dataset]
    hyper = 1e-3 if "computers" in dataset else 1e-4
    return (GCNConfig(layer_dims=(feats, 1000, classes)),
            ADMMConfig(nu=hyper, rho=hyper))


def reduced(dataset: str = "amazon_photo_mini"):
    cfg, admm = config(dataset)
    return GCNConfig(layer_dims=(cfg.layer_dims[0], 64,
                                 cfg.layer_dims[-1])), admm
