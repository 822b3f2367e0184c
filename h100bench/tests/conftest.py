"""Shared fixtures of the benchmark's own tests (CPU; the `cuda` ones
decide inside the test whether a card is there)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(per_layer=()):
    """A cell at a size the CPU runs in seconds: 8 views at 400x300, the
    default stages, limits set from CPU readings at this size."""
    return dict(
        name="tiny", chips=1,
        config=dict(
            scene=dict(generator="dtu_scale", n_cams=8, n_refpoints=300,
                       width=400, height_px=300, focal=550.0),
            edge_graph_config=dict(max_follow_steps=256),
            guarantees=dict(filter_gn_max_mse=2.25, filter_min_views=3,
                            density_cell_size_px=3)),
        limits=dict(gap_px=0.01, edge_points=400, coverage=0.1,
                    med_dist3d=0.012),
        traffic=dict(stages=[1, 2, 3], max_starting_views=None),
        end_to_end=[dict(name="peak_mem_gib", unit="GiB"),
                    dict(name="setup_s", unit="s")],
        per_layer=list(per_layer))


@pytest.fixture
def cell():
    return tiny_cell()
