"""Port parity: ``repro_torch.core.baselines`` (the kd and Zd rebuild
baselines) against ``repro.core.baselines``.

Every ``LeafIndex`` field must be bit-equal to the reference's after the
build and after each delete and insert of a trace, for tie-free
integers, duplicate-heavy input, float32 coordinates in [0, 1) and 3D
(zd with bits = 10), at ``max_depth`` 16 and 24 for kd, with explicit
and default row capacities and masked batches.
``multiset_subtract_mask`` must match with duplicates, absent points and
masks. The facade over both kinds is ``test_torch_baselines_index.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro_torch.core import baselines

torch.set_num_threads(1)

PHI, STEPS, BATCH = 8, 2, 120
HI = 1 << 20


def assert_trees_equal(port_tree, ref_tree, where: str):
    got = port_tree.to_numpy()
    for f in baselines.FIELDS:
        want = np.asarray(getattr(ref_tree, f))
        assert got[f].dtype == want.dtype, (where, f)
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{where}: field {f}")


def _case(name: str, rng):
    """(points, insert batches) for a named input."""
    if name == "float32":
        def draw(n):
            return rng.random((n, 2)).astype(np.float32)
    elif name == "duplicates":
        # 9 distinct points, ~70 copies each: groups that never split
        # below phi, and deletes that pick among equal copies
        def draw(n):
            return (64 * rng.integers(0, 3, size=(n, 2))).astype(np.int32)
    else:
        dim = 3 if name == "3d" else 2

        def draw(n):
            return rng.integers(0, HI, size=(n, dim)).astype(np.int32)
    return draw(640), [draw(BATCH) for _ in range(STEPS)]


_FNS = {"kd": (jbase.kd_build, jbase.kd_insert, jbase.kd_delete,
               baselines.kd_build, baselines.kd_insert, baselines.kd_delete),
        "zd": (jbase.zd_build, jbase.zd_insert, jbase.zd_delete,
               baselines.zd_build, baselines.zd_insert, baselines.zd_delete)}


@pytest.mark.parametrize("kind,name,params", [
    ("kd", "tie-free", dict(max_depth=16)),
    ("kd", "tie-free", dict(max_depth=24)),
    ("kd", "duplicates", dict(max_depth=16)),
    ("kd", "float32", dict(max_depth=16)),
    ("kd", "3d", dict(max_depth=16)),
    ("zd", "tie-free", dict()),
    ("zd", "duplicates", dict()),
    ("zd", "float32", dict()),
    ("zd", "3d", dict(bits=10)),
])
def test_fields_bit_equal_along_trace(kind, name, params):
    j_build, j_insert, j_delete, build, insert, delete = _FNS[kind]
    rng = np.random.default_rng(23)
    pts, batches = _case(name, rng)
    # zd's cells hold one or two points each, so its rows are ~n
    rows = 4 * pts.shape[0] // PHI if kind == "kd" else 2 * pts.shape[0]
    kw = dict(params, capacity_rows=rows)
    ref = j_build(jnp.asarray(pts), phi=PHI, **kw)
    got = build(torch.as_tensor(pts), phi=PHI, **kw)
    assert_trees_equal(got, ref, "build")
    for s, new in enumerate(batches):
        dele = pts[s * BATCH: (s + 1) * BATCH]
        ref = j_delete(ref, jnp.asarray(dele), **kw)
        got = delete(got, torch.as_tensor(dele), **kw)
        assert_trees_equal(got, ref, f"step {s} delete")
        ref = j_insert(ref, jnp.asarray(new), **kw)
        got = insert(got, torch.as_tensor(new), **kw)
        assert_trees_equal(got, ref, f"step {s} insert")
    assert int(got.size) == int(ref.size) == pts.shape[0]


@pytest.mark.parametrize("kind", ["kd", "zd"])
def test_default_capacity_and_masks_bit_equal(kind):
    """No explicit ``capacity_rows``: the update sizes rows from every
    slot plus the batch, as the reference does; masked-out batch entries
    are neither inserted nor deleted. The port's updates start from the
    reference's build carried over by ``LeafIndex.from_numpy``."""
    j_build, j_insert, j_delete, build, insert, delete = _FNS[kind]
    kw = dict(max_depth=16) if kind == "kd" else {}
    rng = np.random.default_rng(29)
    pts = rng.integers(0, HI, size=(300, 2)).astype(np.int32)
    new = rng.integers(0, HI, size=(64, 2)).astype(np.int32)
    m_new = rng.random(64) > 0.3
    m_del = rng.random(64) > 0.3
    ref = j_build(jnp.asarray(pts), phi=PHI, **kw)
    got = baselines.LeafIndex.from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in baselines.FIELDS},
        dict(phi=PHI), "cpu")
    assert got.meta == dict(phi=PHI)
    assert_trees_equal(got, ref, "from_numpy")
    assert_trees_equal(build(torch.as_tensor(pts), phi=PHI, **kw), ref,
                       "build")
    ref = j_insert(ref, jnp.asarray(new), jnp.asarray(m_new), **kw)
    got = insert(got, torch.as_tensor(new), torch.as_tensor(m_new), **kw)
    assert_trees_equal(got, ref, "insert")
    ref = j_delete(ref, jnp.asarray(pts[:64]), jnp.asarray(m_del), **kw)
    got = delete(got, torch.as_tensor(pts[:64]), torch.as_tensor(m_del),
                 **kw)
    assert_trees_equal(got, ref, "delete")
    assert int(got.size) == 300 + int(m_new.sum()) - int(m_del.sum())


@pytest.mark.parametrize("dim", [2, 3])
def test_multiset_subtract_mask_bit_equal(dim):
    """Few distinct coordinates, so runs hold many live copies; deletes
    include points that are absent, more copies than are live, and
    masked-out entries on both sides."""
    rng = np.random.default_rng(dim)
    live = rng.integers(0, 4, size=(400, dim)).astype(np.int32)
    live_ok = rng.random(400) > 0.2
    dels = rng.integers(0, 5, size=(150, dim)).astype(np.int32)
    del_ok = rng.random(150) > 0.2
    for d_ok in (del_ok, None):
        want = np.asarray(jbase.multiset_subtract_mask(
            jnp.asarray(live), jnp.asarray(live_ok), jnp.asarray(dels),
            None if d_ok is None else jnp.asarray(d_ok)))
        got = baselines.multiset_subtract_mask(
            torch.as_tensor(live), torch.as_tensor(live_ok),
            torch.as_tensor(dels),
            None if d_ok is None else torch.as_tensor(d_ok))
        np.testing.assert_array_equal(got.numpy(), want)
