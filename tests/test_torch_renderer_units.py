"""The port's camera sort and stereo baseline
(gs2mesh_torch.pipeline.renderer_stage) against the JAX package's, on the
CPU.

The JAX sort can loop for ever (a visited camera at distance inf is among
its two candidates when one camera is left); the port's considers only
unvisited cameras. JAX's own sort is therefore never called here: seeded
layouts are run through a step-capped copy of its loop over its own
find_nearest_neighbors and choose_by_close_z, and the port's order is
compared wherever that copy ends.
"""

import numpy as np
import pytest

from gs2mesh_tpu.pipeline import renderer_stage as jr
from gs2mesh_torch.pipeline import renderer_stage as pr


def jax_order_capped(coords, cap):
    """JAX's sort_camera_coordinates loop, stopped after ``cap`` steps:
    the order, or None where it did not end."""
    visited = np.zeros(len(coords), dtype=bool)
    order = []
    current = int(np.argmin(coords[:, 2]))
    for _ in range(cap):
        visited[current] = True
        order.append(current)
        if np.all(visited):
            return order
        nn = jr.find_nearest_neighbors(current, coords, visited)
        current = int(jr.choose_by_close_z(current, nn, coords))
    return None


def test_three_camera_layout_ends():
    coords = np.array([(0, 0, 0), (1, 0, 0.1), (0.5, 0, 5)], float)
    assert jax_order_capped(coords, 50) is None     # JAX's loop never ends
    order = pr.sort_camera_coordinates(coords)
    assert sorted(order) == [0, 1, 2]


def test_sort_matches_jax_where_jax_ends():
    compared = hung = 0
    for seed in range(120):
        rng = np.random.default_rng(seed)
        coords = rng.normal(size=(int(rng.integers(3, 40)), 3))
        ref = jax_order_capped(coords, 4 * len(coords))
        order = pr.sort_camera_coordinates(coords)
        assert sorted(order) == list(range(len(coords))), seed
        if ref is None:
            hung += 1
            continue
        assert order == ref, seed
        compared += 1
    assert compared >= 20 and hung > 0, (compared, hung)


class _Args:
    def __init__(self, **kw):
        self.renderer_baseline_absolute = None
        self.renderer_baseline_percentage = 7.0
        self.renderer_scene_360 = True
        self.dataset_name = "custom"
        self.__dict__.update(kw)


BRANCHES = {
    "absolute": dict(renderer_baseline_absolute=0.123),
    "360_median": {},
    "360_median_dtu_x2": dict(dataset_name="DTU"),
    "sphere_fit": dict(renderer_scene_360=False,
                       renderer_baseline_percentage=14.0),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("branch", BRANCHES)
def test_compute_baseline_matches_jax(branch, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(30 + 10 * seed, 3))
    locs = rng.normal(size=3) + rng.uniform(1, 5) * v / np.linalg.norm(
        v, axis=1, keepdims=True)
    args = _Args(**BRANCHES[branch])
    got = pr.compute_baseline(locs, args)
    assert got == jr.compute_baseline(locs, args)
    assert got > 0
