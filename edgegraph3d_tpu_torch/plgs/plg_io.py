"""2D PLG serialization (checkpoint/resume of the extraction stage).

Parity: the reference's boost text archives for PLG vectors
(reference: src/edgegraph3d/plgs/plg_handling.cpp:45-93 write_plgs /
read_plgs '.plg' files, polyline_graph_2d_hmap_impl.cpp:268-280
serialize_plg).  Here one npz per stack — stage-boundary checkpoints
that let the pipeline resume after extraction.
"""

from __future__ import annotations

import numpy as np

from edgegraph3d_tpu_torch.plgs.polyline_graph import PLGStack


def save_plg_stack(stack: PLGStack, path: str) -> None:
    np.savez_compressed(path, coords=stack.coords, length=stack.length,
                        start_node=stack.start_node,
                        end_node=stack.end_node)


def load_plg_stack(path: str) -> PLGStack:
    z = np.load(path)
    return PLGStack(coords=z["coords"], length=z["length"],
                    start_node=z["start_node"], end_node=z["end_node"])


def transform_plgs(stack: PLGStack, config=None) -> PLGStack:
    """Re-run the optimize passes on deserialized PLGs (parity:
    transform_plgs, plg_handling.cpp:70-93 — optimize() then
    connect_close_extremes + remove_2connection_nodes + simplify on
    every graph).  Here `optimize_chains` already applies that full pass
    order, and a second merge+simplify round matches the reference's
    explicit trailing calls."""
    from edgegraph3d_tpu_torch.config import EdgeGraphConfig
    from edgegraph3d_tpu_torch.plgs.extraction import (merge_degree2_nodes,
                                                 optimize_chains,
                                                 simplify_polyline)
    from edgegraph3d_tpu_torch.plgs.polyline_graph import (from_polyline_list,
                                                     stack_plgs)
    cfg = config or EdgeGraphConfig()
    P, L = stack.coords.shape[1], stack.coords.shape[2]
    plgs = []
    for v in range(stack.n_views):
        g = stack.view(v)
        chains = [g.polyline(p) for p in range(g.coords.shape[0])
                  if g.length[p] >= 2]
        chains = optimize_chains(chains, cfg)
        chains = merge_degree2_nodes(chains)
        chains = [simplify_polyline(c, cfg.simplify_tolerance_px)
                  for c in chains]
        plgs.append(from_polyline_list(chains, max_polylines=P, max_len=L))
    return stack_plgs(plgs, max_polylines=P, max_len=L)
