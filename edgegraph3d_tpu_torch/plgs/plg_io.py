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
