"""Cluster specification for Helix planning.

A cluster is a coordinator plus a set of heterogeneous compute nodes joined by
network links.  This module is hardware-agnostic: a "node" can be a single
GPU (the paper's setting) or a TPU slice (our adaptation); all the planner
sees is a throughput profile (tokens/s as a function of #layers held), a VRAM
budget, and link bandwidth/latency.

Capacities follow the paper's §3.2 graph abstraction:
  * node capacity  = min(compute tokens/s, NIC tokens/s)
  * link capacity  = bandwidth / per-token transmission size
    (tokens coordinator<->node are ~4 B; activations node<->node are
     ~2*d_model bytes in fp16).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

COORDINATOR = "coordinator"


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Profiled performance of one device type.

    ``token_throughput(num_layers)`` follows the paper's one-time profiling:
    the max number of tokens/s a node can process when holding ``num_layers``
    layers.  We model it as ``flops_per_s / flops_per_token_per_layer /
    num_layers`` saturated by a per-node batching ceiling.
    """

    name: str
    # Effective sustained FLOP/s for transformer inference (already derated
    # from peak; the paper profiles tokens/s directly).
    flops: float
    vram_bytes: float
    # NIC bandwidth in bytes/s (node-level network processing ceiling).
    nic_bytes_per_s: float
    # Max tokens the engine can batch per second regardless of layer count
    # (scheduler / engine overhead ceiling).
    max_tokens_per_s: float = 5.0e5
    # Rental price in $/hr (on-demand cloud list-ish) — the objective the
    # Mélange-style mix planner minimizes.  0.0 means "not priced" (free),
    # which keeps cost-unaware callers unchanged.
    cost_per_hour: float = 0.0

    def tokens_per_s(self, num_layers: int, flops_per_token_layer: float) -> float:
        if num_layers <= 0:
            return 0.0
        t = self.flops / (flops_per_token_layer * num_layers)
        return min(t, self.max_tokens_per_s)


# --- Device profiles -------------------------------------------------------
# GPU profiles mirror the paper's cluster (A100 / V100 / L4 / T4); numbers are
# effective serving FLOP/s (~40% of peak fp16 dense) and full VRAM.  TPU
# profiles are the v5e targets used for the TPU-adapted clusters.
DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    "A100": DeviceProfile("A100", flops=312e12 * 0.40, vram_bytes=80e9, nic_bytes_per_s=1.25e9, cost_per_hour=3.67),
    "V100": DeviceProfile("V100", flops=125e12 * 0.40, vram_bytes=32e9, nic_bytes_per_s=1.25e9, cost_per_hour=2.48),
    "L4": DeviceProfile("L4", flops=121e12 * 0.40, vram_bytes=24e9, nic_bytes_per_s=1.25e9, cost_per_hour=0.81),
    "T4": DeviceProfile("T4", flops=65e12 * 0.40, vram_bytes=16e9, nic_bytes_per_s=1.25e9, cost_per_hour=0.35),
    # TPU v5e chip: 197 TFLOP/s bf16 peak, 16 GB HBM.
    "TPUv5e": DeviceProfile("TPUv5e", flops=197e12 * 0.45, vram_bytes=16e9, nic_bytes_per_s=6.25e9, cost_per_hour=1.20),
    # A 4-chip v5e slice acting as one Helix node (TP within the slice).
    "TPUv5e-4": DeviceProfile("TPUv5e-4", flops=4 * 197e12 * 0.42, vram_bytes=64e9, nic_bytes_per_s=6.25e9, cost_per_hour=4.80),
    "TPUv5e-8": DeviceProfile("TPUv5e-8", flops=8 * 197e12 * 0.40, vram_bytes=128e9, nic_bytes_per_s=6.25e9, cost_per_hour=9.60),
}


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One compute node (GPU or TPU slice) in the cluster."""

    name: str
    device: DeviceProfile
    region: str = "r0"
    # Tensor-parallel degree inside the node (multi-GPU node / TPU slice).
    tp_degree: int = 1
    # Per-node $/hr override; None prices the node from its device profile
    # (tp_degree GPUs rented together).
    hourly_cost: Optional[float] = None

    @property
    def flops(self) -> float:
        return self.device.flops * self.tp_degree

    @property
    def vram_bytes(self) -> float:
        return self.device.vram_bytes * self.tp_degree

    @property
    def cost_per_hour(self) -> float:
        if self.hourly_cost is not None:
            return self.hourly_cost
        return self.device.cost_per_hour * self.tp_degree


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Directed network link between two nodes (or coordinator<->node)."""

    src: str
    dst: str
    bandwidth_bytes_per_s: float
    latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Serving-relevant facts about the model being placed."""

    name: str
    num_layers: int
    d_model: int
    # Bytes of parameters for one layer (fp16/bf16).
    layer_param_bytes: float
    # FLOPs to process one token through one layer (decode-phase, amortized).
    flops_per_token_layer: float
    # Bytes of KV cache per token per layer.
    kv_bytes_per_token_layer: float
    # Activation size per token at a layer boundary (what pipelines transmit).
    activation_bytes: float
    # Token id transmission size coordinator<->node.
    token_bytes: float = 4.0

    @staticmethod
    def from_dims(name: str, num_layers: int, d_model: int, d_ff: int,
                  vocab: int, n_kv_heads: int, head_dim: int,
                  dtype_bytes: float = 2.0, moe_experts: int = 0,
                  moe_topk: int = 0, kv_dtype: str = "param",
                  kv_page_size: int = 16) -> "ModelProfile":
        # Per-layer params: attn (qkvo) + mlp.  MoE multiplies the FFN by the
        # expert count for *storage* but only top-k for *compute*.
        attn = 4 * d_model * d_model
        ffn = 3 * d_model * d_ff  # gated mlp
        storage_ffn = ffn * (moe_experts if moe_experts else 1)
        compute_ffn = ffn * (moe_topk if moe_topk else 1)
        layer_param_bytes = (attn + storage_ffn) * dtype_bytes
        flops_per_token_layer = 2 * (attn + compute_ffn)
        if kv_dtype == "int8":
            # int8 pages: 1 byte/element + one f32 absmax per (page, kv_head)
            # for K and V each, amortized over the page's tokens — mirrors
            # serving.kv_pool.page_bytes so the planner/simulator see the
            # same ~2x capacity the engines actually get
            kv = (2 * n_kv_heads * head_dim * 1.0
                  + 2 * n_kv_heads * 4.0 / kv_page_size)
        elif kv_dtype in (None, "param"):
            kv = 2 * n_kv_heads * head_dim * dtype_bytes
        else:
            raise ValueError(f"kv_dtype must be 'param' or 'int8', "
                             f"got {kv_dtype!r}")
        return ModelProfile(
            name=name,
            num_layers=num_layers,
            d_model=d_model,
            layer_param_bytes=layer_param_bytes,
            flops_per_token_layer=flops_per_token_layer,
            kv_bytes_per_token_layer=kv,
            activation_bytes=d_model * dtype_bytes,
        )


# Models used in the paper's evaluation.
LLAMA_30B = ModelProfile.from_dims("llama-30b", num_layers=60, d_model=6656,
                                   d_ff=17920, vocab=32000, n_kv_heads=52,
                                   head_dim=128)
LLAMA_70B = ModelProfile.from_dims("llama-70b", num_layers=80, d_model=8192,
                                   d_ff=28672, vocab=32000, n_kv_heads=8,
                                   head_dim=128)


@dataclasses.dataclass
class ClusterSpec:
    """Coordinator + nodes + directed links."""

    nodes: Dict[str, NodeSpec]
    links: Dict[Tuple[str, str], LinkSpec]
    coordinator_region: str = "r0"

    # ------------------------------------------------------------------
    def node_names(self) -> List[str]:
        return sorted(self.nodes)

    def out_links(self, name: str) -> List[LinkSpec]:
        return [l for (s, _), l in sorted(self.links.items()) if s == name]

    def in_links(self, name: str) -> List[LinkSpec]:
        return [l for (_, d), l in sorted(self.links.items()) if d == name]

    def link(self, src: str, dst: str) -> Optional[LinkSpec]:
        return self.links.get((src, dst))

    def remove_node(self, name: str) -> "ClusterSpec":
        """Fault tolerance: cluster with ``name`` removed (links pruned)."""
        nodes = {k: v for k, v in self.nodes.items() if k != name}
        links = {k: v for k, v in self.links.items()
                 if name not in (k[0], k[1])}
        return ClusterSpec(nodes=nodes, links=links,
                           coordinator_region=self.coordinator_region)

    def cost_per_hour(self) -> float:
        """Total rental price of the cluster in $/hr (coordinator is free)."""
        return sum(n.cost_per_hour for n in self.nodes.values())

    def add_node(self, spec: NodeSpec, *,
                 bandwidth_bytes_per_s: Optional[float] = None,
                 latency_s: Optional[float] = None) -> "ClusterSpec":
        """Elastic scale-up: cluster with ``spec`` added, full-mesh linked to
        the coordinator and every existing node.  Link bandwidth/latency
        default to the median of the existing links so a grown cluster keeps
        the fabric it already has."""
        if spec.name in self.nodes or spec.name == COORDINATOR:
            raise ValueError(f"node {spec.name!r} already exists")
        if self.links and (bandwidth_bytes_per_s is None or latency_s is None):
            bws = sorted(l.bandwidth_bytes_per_s for l in self.links.values())
            lats = sorted(l.latency_s for l in self.links.values())
            if bandwidth_bytes_per_s is None:
                bandwidth_bytes_per_s = bws[len(bws) // 2]
            if latency_s is None:
                latency_s = lats[len(lats) // 2]
        bw = bandwidth_bytes_per_s if bandwidth_bytes_per_s is not None \
            else 10e9 / 8
        lat = latency_s if latency_s is not None else 1e-3
        nodes = dict(self.nodes)
        nodes[spec.name] = spec
        links = dict(self.links)
        for other in [COORDINATOR] + list(self.nodes):
            links[(other, spec.name)] = LinkSpec(other, spec.name, bw, lat)
            links[(spec.name, other)] = LinkSpec(spec.name, other, bw, lat)
        return ClusterSpec(nodes=nodes, links=links,
                           coordinator_region=self.coordinator_region)

    def degrade_node(self, name: str, factor: float) -> "ClusterSpec":
        """Straggler modelling: scale a node's throughput by ``factor``."""
        node = self.nodes[name]
        dev = dataclasses.replace(node.device,
                                  flops=node.device.flops * factor,
                                  max_tokens_per_s=node.device.max_tokens_per_s * factor)
        nodes = dict(self.nodes)
        nodes[name] = dataclasses.replace(node, device=dev)
        return ClusterSpec(nodes=nodes, links=self.links,
                           coordinator_region=self.coordinator_region)

    # ------------------------------------------------------------------
    def max_layers_on(self, node: str, model: ModelProfile,
                      param_frac: float = 0.5) -> int:
        """Max layers a node can hold using ``param_frac`` of VRAM for params
        (the rest is reserved for KV-cache, mirroring Table 1's convention)."""
        budget = self.nodes[node].vram_bytes * param_frac
        return max(0, min(model.num_layers, int(budget // model.layer_param_bytes)))

    def node_token_throughput(self, node: str, model: ModelProfile,
                              num_layers: int) -> float:
        """Paper §3.2: node capacity = min(compute, NIC) in tokens/s."""
        if num_layers <= 0:
            return 0.0
        spec = self.nodes[node]
        compute = (spec.flops / (model.flops_per_token_layer * num_layers))
        compute = min(compute, spec.device.max_tokens_per_s)
        nic = spec.device.nic_bytes_per_s / model.activation_bytes
        return min(compute, nic)

    def link_token_capacity(self, src: str, dst: str, model: ModelProfile) -> float:
        link = self.links[(src, dst)]
        if COORDINATOR in (src, dst):
            per_token = model.token_bytes
        else:
            per_token = model.activation_bytes
        return link.bandwidth_bytes_per_s / per_token


# ---------------------------------------------------------------------------
# Cluster builders for the paper's three setups + TPU variants.
# ---------------------------------------------------------------------------

def _full_mesh_links(names: Sequence[str], regions: Mapping[str, str],
                     intra_bw: float, intra_lat: float,
                     inter_bw: float, inter_lat: float) -> Dict[Tuple[str, str], LinkSpec]:
    links: Dict[Tuple[str, str], LinkSpec] = {}
    all_names = [COORDINATOR] + list(names)
    for src in all_names:
        for dst in all_names:
            if src == dst:
                continue
            same = regions.get(src, "r0") == regions.get(dst, "r0")
            bw, lat = (intra_bw, intra_lat) if same else (inter_bw, inter_lat)
            links[(src, dst)] = LinkSpec(src, dst, bw, lat)
    return links


def full_mesh_cluster(devs, *, bandwidth: float = 10e9 / 8,
                      latency_s: float = 1e-3) -> ClusterSpec:
    """Single-region full-mesh cluster over named device types — or an int
    for that many A100s.  The builder the tests, their harness, and the
    benchmarks share for controlled-topology experiments."""
    if isinstance(devs, int):
        devs = ["A100"] * devs
    nodes: Dict[str, NodeSpec] = {}
    regions = {COORDINATOR: "r0"}
    for i, d in enumerate(devs):
        name = f"n{i}"
        nodes[name] = NodeSpec(name, DEVICE_PROFILES[d], region="r0")
        regions[name] = "r0"
    links = _full_mesh_links(list(nodes), regions, bandwidth, latency_s,
                             bandwidth, latency_s)
    return ClusterSpec(nodes=nodes, links=links)


def make_serving_cluster(profile: ModelProfile,
                         devs: Sequence[str] = ("A100", "L4", "T4"),
                         force_stages: int = 0,
                         param_frac: float = 0.5) -> ClusterSpec:
    """Small full-mesh heterogeneous cluster for the serving drivers.

    With ``force_stages`` the per-node VRAM is derated so no node can hold
    more than ``ceil(num_layers / force_stages)`` layers under the planner's
    ``param_frac`` VRAM convention — the MILP then *must* split the model
    into at least that many pipeline stages.
    """
    nodes: Dict[str, NodeSpec] = {}
    regions: Dict[str, str] = {COORDINATOR: "r0"}
    for i, d in enumerate(devs):
        dev = DEVICE_PROFILES[d.strip()]
        if force_stages > 0:
            cap = -(-profile.num_layers // force_stages)
            dev = dataclasses.replace(
                dev,
                vram_bytes=(cap + 0.5) * profile.layer_param_bytes / param_frac)
        name = f"n{i}"
        nodes[name] = NodeSpec(name, dev, region="r0")
        regions[name] = "r0"
    links = _full_mesh_links(list(nodes), regions, 10e9 / 8, 1e-3,
                             10e9 / 8, 1e-3)
    return ClusterSpec(nodes=nodes, links=links)


def make_single_cluster(seed_counts: Optional[Mapping[str, int]] = None) -> ClusterSpec:
    """Paper §5.2 single-cluster: 4×A100 + 8×L4 + 12×T4, 10 Gb/s, <1 ms."""
    counts = dict(seed_counts or {"A100": 4, "L4": 8, "T4": 12})
    nodes: Dict[str, NodeSpec] = {}
    regions: Dict[str, str] = {COORDINATOR: "r0"}
    for dev, n in counts.items():
        for i in range(n):
            name = f"{dev.lower()}-{i}"
            nodes[name] = NodeSpec(name, DEVICE_PROFILES[dev], region="r0")
            regions[name] = "r0"
    links = _full_mesh_links(list(nodes), regions,
                             intra_bw=10e9 / 8, intra_lat=1e-3,
                             inter_bw=10e9 / 8, inter_lat=1e-3)
    return ClusterSpec(nodes=nodes, links=links)


def make_distributed_cluster() -> ClusterSpec:
    """Paper §5.2 distributed: 3 regions, 100 Mb/s + 50 ms across regions.

    region r0: 4×A100; r1: 2×L4 + 8×T4; r2: 6×L4 + 4×T4.
    """
    layout = {
        "r0": [("A100", 4)],
        "r1": [("L4", 2), ("T4", 8)],
        "r2": [("L4", 6), ("T4", 4)],
    }
    nodes: Dict[str, NodeSpec] = {}
    regions: Dict[str, str] = {COORDINATOR: "r0"}
    for region, devs in layout.items():
        for dev, n in devs:
            for i in range(n):
                name = f"{region}-{dev.lower()}-{i}"
                nodes[name] = NodeSpec(name, DEVICE_PROFILES[dev], region=region)
                regions[name] = region
    links = _full_mesh_links(list(nodes), regions,
                             intra_bw=10e9 / 8, intra_lat=1e-3,
                             inter_bw=100e6 / 8, inter_lat=50e-3)
    return ClusterSpec(nodes=nodes, links=links)


def make_high_heterogeneity_cluster() -> ClusterSpec:
    """Paper §5.5: 42 nodes, 7 types: 4×A100, 6×V100, 8×L4, 10×T4,
    4×(2×L4), 6×(2×T4), 4×(4×T4)."""
    layout = [
        ("A100", 4, 1), ("V100", 6, 1), ("L4", 8, 1), ("T4", 10, 1),
        ("L4", 4, 2), ("T4", 6, 2), ("T4", 4, 4),
    ]
    nodes: Dict[str, NodeSpec] = {}
    regions: Dict[str, str] = {COORDINATOR: "r0"}
    for dev, n, tp in layout:
        for i in range(n):
            name = f"{dev.lower()}x{tp}-{i}"
            nodes[name] = NodeSpec(name, DEVICE_PROFILES[dev], region="r0", tp_degree=tp)
            regions[name] = "r0"
    links = _full_mesh_links(list(nodes), regions,
                             intra_bw=10e9 / 8, intra_lat=1e-3,
                             inter_bw=10e9 / 8, inter_lat=1e-3)
    return ClusterSpec(nodes=nodes, links=links)


def make_tpu_pod_cluster(num_slices: int = 8, chips_per_slice: int = 4,
                         regions: int = 2) -> ClusterSpec:
    """TPU adaptation: heterogeneous mix of v5e slices across regions.

    Half the slices are ``chips_per_slice``-chip, a quarter are 8-chip, and a
    quarter single-chip — mimicking incremental fleet deployment.
    """
    nodes: Dict[str, NodeSpec] = {}
    region_of: Dict[str, str] = {COORDINATOR: "r0"}
    kinds = ["TPUv5e-4", "TPUv5e-8", "TPUv5e", "TPUv5e-4"]
    for i in range(num_slices):
        kind = kinds[i % len(kinds)]
        region = f"r{i % regions}"
        name = f"slice-{i}"
        nodes[name] = NodeSpec(name, DEVICE_PROFILES[kind], region=region)
        region_of[name] = region
    links = _full_mesh_links(list(nodes), region_of,
                             intra_bw=6.25e9, intra_lat=1e-4,
                             inter_bw=100e6 / 8, inter_lat=50e-3)
    return ClusterSpec(nodes=nodes, links=links)
