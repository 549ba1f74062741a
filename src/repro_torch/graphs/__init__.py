"""Graph containers, partitioning, generators, the Tab. 1 stand-ins and
the corpus: named presets, the SNAP and MatrixMarket parsers, the
content-addressed store and the ordering transforms."""

from repro_torch.graphs.corpus import (GRAPH_PRESETS, GraphPreset,
                                       GraphStore, bfs_reorder, degree_sort,
                                       graph_name, graph_variants,
                                       resolve_graph, shuffle)
from repro_torch.graphs.formats import (Graph, GraphParseError,
                                        load_matrix_market,
                                        load_snap_edgelist)

__all__ = [
    "Graph", "GraphParseError", "load_snap_edgelist", "load_matrix_market",
    "GRAPH_PRESETS", "GraphPreset", "GraphStore", "resolve_graph",
    "graph_variants", "graph_name", "degree_sort", "bfs_reorder", "shuffle",
]
