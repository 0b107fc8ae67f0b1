"""Top-K serving: the port of ``cfk_tpu.serving`` on one device.

K4 ``topk_scores`` (``topk_kernel``, ``csrc/topk_scores.cu``) scores a user
batch against the (optionally quantized) item table and keeps each user's K
best without writing a [B, M] score matrix; ``ServeEngine`` holds the live
factors, seen lists and overlays (``engine``); a k-means index and a
centroid probe shortlist the rows for two-stage retrieval (``cluster``,
``twostage``); ``RecommendServer`` coalesces requests from a log into
batches (``server``), and an open-loop generator measures QPS and latency
(``loadgen``).  ``ServeFleet`` puts N such servers behind one request log
with user-keyed routing, factor-delta shipping, epoch rollover, admission
control and failover (``fleet``).
"""

from cfk_tpu_torch.serving.cluster import (
    ClusterIndex,
    build_cluster_index,
    kmeans_item_clusters,
)
from cfk_tpu_torch.serving.engine import ServeEngine, engine_from_model, pad_table
from cfk_tpu_torch.serving.fleet import (
    DELTAS_TOPIC,
    AdmissionController,
    DeltaPublisher,
    FleetReplica,
    ServeFleet,
    SnapshotStore,
    ensure_deltas_topic,
    table_crc,
)
from cfk_tpu_torch.serving.loadgen import (
    LoadReport,
    run_open_loop,
    warm_serve_programs,
    zipf_user_rows,
)
from cfk_tpu_torch.serving.server import (
    REQUESTS_TOPIC,
    RESPONSES_TOPIC,
    RecommendServer,
    ServeClient,
    ensure_serve_topics,
)
from cfk_tpu_torch.serving.topk_kernel import (
    build_seen_tiles,
    topk_scores,
    topk_scores_plain,
)
from cfk_tpu_torch.serving.twostage import (
    Shortlist,
    build_shortlist,
    default_two_stage_params,
    recall_at_k,
)

__all__ = [
    "AdmissionController",
    "ClusterIndex",
    "DELTAS_TOPIC",
    "DeltaPublisher",
    "FleetReplica",
    "LoadReport",
    "REQUESTS_TOPIC",
    "RESPONSES_TOPIC",
    "RecommendServer",
    "ServeClient",
    "ServeEngine",
    "ServeFleet",
    "Shortlist",
    "SnapshotStore",
    "build_cluster_index",
    "build_seen_tiles",
    "build_shortlist",
    "default_two_stage_params",
    "engine_from_model",
    "ensure_deltas_topic",
    "ensure_serve_topics",
    "kmeans_item_clusters",
    "pad_table",
    "recall_at_k",
    "run_open_loop",
    "table_crc",
    "topk_scores",
    "topk_scores_plain",
    "warm_serve_programs",
    "zipf_user_rows",
]
