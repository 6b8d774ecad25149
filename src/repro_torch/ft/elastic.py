"""Elastic scaling (rebuild the mesh after node loss, re-shard the state):
not ported.  The JAX package's ``repro.ft.elastic`` works on device meshes,
which the port gets with tensor parallelism; until then each entry point
raises, naming the ROADMAP item that brings it."""
from __future__ import annotations

_WHY = ("elastic re-sharding needs device meshes: not ported yet — ROADMAP "
        "queue 1 item 12 (tensor parallel)")


def elastic_meshes(model_axis: int):
    raise NotImplementedError(_WHY)


def reshard_tree(tree, shardings):
    raise NotImplementedError(_WHY)
