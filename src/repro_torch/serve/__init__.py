"""repro_torch.serve — low-latency community-sharded GCN inference.

The port of ``repro.serve``: a trained model's community layout makes
single-node inference cacheable — ``CommunityServer`` answers hits with one
row gather out of a per-community embedding block, recomputes misses with
the packed ELL kernels over exactly the stale community's rows, and
invalidates feature updates along the community read closure.
``RequestBatcher`` coalesces a node-request queue into pad_ladder-bucketed
per-community batches; ``zipf_node_stream`` generates the heavy-tailed
benchmark traffic.
"""
from repro_torch.serve.batcher import CommunityBatch, RequestBatcher
from repro_torch.serve.cache import CacheStats, FrequencySketch, LRUCache
from repro_torch.serve.engine import CommunityServer, ServeConfig
from repro_torch.serve.traffic import zipf_node_stream

__all__ = [
    "CacheStats", "CommunityBatch", "CommunityServer", "FrequencySketch",
    "LRUCache", "RequestBatcher", "ServeConfig", "zipf_node_stream",
]
