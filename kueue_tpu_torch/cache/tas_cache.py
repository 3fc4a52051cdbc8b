"""Topology-aware-scheduling cache: flavor → topology tree state.

Capability parity with reference pkg/cache/tas_cache.go + tas_flavor.go.
The full assignment algorithm lives in kueue_tpu_torch.cache.tas_snapshot
(reference tas_flavor_snapshot.go); its kernels run on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api.types import ResourceFlavor, Topology


@dataclass
class NodeInfo:
    """A schedulable node feeding the topology tree."""
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    capacity: dict[str, int] = field(default_factory=dict)  # canonical ints
    ready: bool = True


@dataclass
class FlavorTASInfo:
    flavor_name: str
    topology_name: str
    levels: list[str] = field(default_factory=list)
    node_labels: dict[str, str] = field(default_factory=dict)


class TASCache:
    """reference pkg/cache/tas_cache.go."""

    def __init__(self):
        self.topologies: dict[str, Topology] = {}
        self.flavors: dict[str, FlavorTASInfo] = {}
        self.nodes: dict[str, NodeInfo] = {}
        # usage per flavor per leaf-domain id, canonical ints
        self.usage: dict[str, dict[tuple, dict[str, int]]] = {}
        self.device = "cuda"   # the Driver's; stamped on every snapshot

    def add_topology(self, topology: Topology) -> None:
        self.topologies[topology.name] = topology
        for fi in self.flavors.values():
            if fi.topology_name == topology.name:
                fi.levels = list(topology.levels)

    def delete_topology(self, name: str) -> None:
        self.topologies.pop(name, None)
        for fi in self.flavors.values():
            if fi.topology_name == name:
                fi.levels = []

    def bind_flavor(self, flavor: ResourceFlavor) -> None:
        topo = self.topologies.get(flavor.topology_name or "")
        self.flavors[flavor.name] = FlavorTASInfo(
            flavor_name=flavor.name,
            topology_name=flavor.topology_name or "",
            levels=list(topo.levels) if topo else [],
            node_labels=dict(flavor.node_labels),
        )
        self.usage.setdefault(flavor.name, {})

    def unbind_flavor(self, name: str) -> None:
        self.flavors.pop(name, None)
        self.usage.pop(name, None)

    def add_or_update_node(self, node: NodeInfo) -> None:
        self.nodes[node.name] = node

    def delete_node(self, name: str) -> None:
        self.nodes.pop(name, None)

    def add_usage(self, flavor: str, domain: tuple, requests: dict[str, int],
                  sign: int = +1) -> None:
        per_flavor = self.usage.setdefault(flavor, {})
        dom = per_flavor.setdefault(domain, {})
        for rname, qty in requests.items():
            dom[rname] = dom.get(rname, 0) + sign * qty

    def snapshot(self) -> dict:
        """Build per-flavor topology snapshots for a scheduling cycle."""
        from .tas_snapshot import TASFlavorSnapshot
        out = {}
        for fname, info in self.flavors.items():
            if not info.levels:
                continue
            nodes = [n for n in self.nodes.values()
                     if n.ready and all(n.labels.get(k) == v
                                        for k, v in info.node_labels.items())]
            out[fname] = TASFlavorSnapshot.build(
                flavor=fname, levels=info.levels, nodes=nodes,
                usage=self.usage.get(fname, {}))
            out[fname].device = self.device
        return out
