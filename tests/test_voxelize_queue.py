"""Work-queue parity voxelizer vs the jnp oracle.

Both folds of the queue (ops/voxelize_queue.py) must produce bit-identical
packed occupancy to voxelize_parity_ref — same per-triangle setup, same
coverage expressions, different reduction (XOR fold vs crossing count),
mirroring the reference's dual Core/EZ implementations (SURVEY.md
section 4). The Triton-route kernel runs in interpret mode here; the plain
fold is the CPU product path.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dxrvoxelizer_tpu.ops import voxelize_queue as vq
from dxrvoxelizer_tpu.ops.packing import pack_bits_z, unpack_bits_z
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

FOLDS = ("kernel", "xla")


def _fold(name):
    if name == "kernel":
        return partial(vq.queue_fold_triton, interpret=True)
    return vq.queue_fold_xla


def _two_boxes():
    v1, _, t1 = box_mesh([-0.9, -0.9, -0.9], [-0.1, -0.2, -0.3])
    v2, _, t2 = box_mesh([0.2, 0.1, 0.05], [0.8, 0.75, 0.9])
    return np.concatenate([v1, v2]), np.concatenate([t1, t2 + len(v1)])


def _cases():
    tv, _, tt = box_mesh(np.array([-0.7, -0.5, -0.3]), np.array([0.4, 0.8, 0.6]))
    bv, _, bt = box_mesh([-0.52, 0.07, -0.73], [0.31, 0.81, 0.22])
    sv, _, st = tetrahedron_mesh()
    iv, _, it = icosphere_mesh(2)
    fv, _, ft = box_mesh([4.0, 4.0, 4.0], [5.0, 5.0, 5.0])  # off-grid
    return {
        "tet": (sv, st),
        "box": (tv, tt),
        "box2": (bv, bt),
        "two_boxes": _two_boxes(),
        # scaled past the grid bounds: dense multi-chunk runs + clipping
        "ico_dense": (iv * 1.07 + np.array([0.02, -0.03, 0.01]), it),
        "off_grid": (fv, ft),
    }


def _mesh(name):
    v, t = _cases()[name]
    return jnp.asarray(v, jnp.float32), jnp.asarray(t, jnp.int32)


def _oracle(v, t, n):
    return np.asarray(pack_bits_z(voxelize_parity_ref(v, t, n=n)))


def _run(v, t, n, fold, **build_kw):
    coefs, row0, count, stats = vq.build_queue(v, t, n, **build_kw)
    tiles = _fold(fold)(coefs, row0, count, 0, n)
    return np.asarray(vq._tiles_to_grid(tiles, n)), stats


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize(
    "name", ["tet", "box", "box2", "two_boxes", "ico_dense", "off_grid"]
)
def test_queue_matches_oracle(name, n, fold):
    v, t = _mesh(name)
    got, _ = _run(v, t, n, fold)
    np.testing.assert_array_equal(got, _oracle(v, t, n))
    assert unpack_bits_z(jnp.asarray(got), n).any() == (name != "off_grid")


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("n", [96, 128])
def test_queue_wide_grids(n, fold):
    """n = 96 pads the word axis to a power of two inside the kernel;
    128 is the first grid with four words per column."""
    v, t = _mesh("tet")
    got, _ = _run(v, t, n, fold)
    np.testing.assert_array_equal(got, _oracle(v, t, n))


@pytest.mark.parametrize("n", [32, 64])
def test_two_meshes_union_parity(n):
    """Parity voxelization of two disjoint solids == union of the runs."""
    v1, _, t1 = box_mesh([-0.9, -0.9, -0.9], [-0.1, -0.2, -0.3])
    v2, _, t2 = box_mesh([0.2, 0.1, 0.05], [0.8, 0.75, 0.9])
    both = unpack_bits_z(vq.voxelize_parity_queue(*_mesh("two_boxes"), n), n)
    a = unpack_bits_z(
        vq.voxelize_parity_queue(jnp.asarray(v1), jnp.asarray(t1), n), n
    )
    b = unpack_bits_z(
        vq.voxelize_parity_queue(jnp.asarray(v2), jnp.asarray(t2), n), n
    )
    np.testing.assert_array_equal(np.asarray(both), np.asarray(a | b))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    occ = rng.random((32, 32, 32)) > 0.5
    words = pack_bits_z(jnp.asarray(occ))
    back = np.asarray(unpack_bits_z(words, 32))
    np.testing.assert_array_equal(back, occ)


def test_queue_empty_mesh():
    out = vq.voxelize_parity_queue(
        jnp.zeros((0, 3), jnp.float32), jnp.zeros((0, 3), jnp.int32), 64
    )
    assert not unpack_bits_z(out, 64).any()


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("case", [("box", 128), ("giant_box", 64)])
def test_queue_overflow_path(case, fold):
    """Triangles wider than the span caps route through the overflow list
    (appended to every tile's run) and still land in every tile they
    cover — max_span = 1 forces it for every face."""
    name, n = case
    if name == "giant_box":
        v, _, t = box_mesh([-0.95, -0.95, -0.95], [0.95, 0.95, 0.95])
        v, t = jnp.asarray(v, jnp.float32), jnp.asarray(t, jnp.int32)
    else:
        v, t = _mesh(name)
    got, stats = _run(v, t, n, fold, max_span_x=1, max_span_y=1)
    assert stats.overflow > 0
    np.testing.assert_array_equal(got, _oracle(v, t, n))


def test_build_queue_stats():
    """Runs start on chunk boundaries, cover every (tile, tri) pair, and
    the padded chunk count is a multiple of 128."""
    v, t = _mesh("box")
    n = 64
    coefs, row0, count, stats = vq.build_queue(v, t, n, k_chunk=64)
    row0, count = np.asarray(row0), np.asarray(count)
    assert stats.n_tiles == (n // vq.TILE_X) * (n // vq.TILE_Y) == row0.size
    assert stats.num_chunks % 128 == 0
    assert coefs.shape == (stats.num_chunks * 64, vq.NCOEF)
    assert (row0 % 64 == 0).all() and int(count.sum()) == stats.pairs
    ends = row0 + -(-count // 64) * 64
    assert (row0[1:] >= ends[:-1]).all()  # runs never overlap
    assert ends.max() <= stats.real_chunks * 64


@pytest.mark.parametrize("fold", FOLDS)
def test_deforming_voxelizer_device_layout(fold):
    """The no-host-sync device queue build matches the oracle across
    deformed frames (the BASELINE deforming-mesh config)."""
    v, t = _mesh("tet")
    n = 64
    for scale in (1.0, 1.05, 0.93):
        vv = v * scale
        coefs, row0, count, ok = vq._build_queue_device(
            vv, t, n, 128, 64, 4, 8
        )
        assert bool(ok)
        got = vq._tiles_to_grid(_fold(fold)(coefs, row0, count, 0, n), n)
        np.testing.assert_array_equal(np.asarray(got), _oracle(vv, t, n))


def test_static_voxelizer_matches_queue():
    """Build-once StaticVoxelizer == the per-call queue path, bit-for-bit,
    across repeated dispatches (incl. the benchmark perturb no-op)."""
    v, t = _mesh("box")
    n = 64
    want = np.asarray(vq.voxelize_parity_queue(v, t, n, interpret=True))
    sv = vq.StaticVoxelizer(v, t, n, interpret=True)
    np.testing.assert_array_equal(np.asarray(sv()), want)
    np.testing.assert_array_equal(
        np.asarray(sv(perturb=jnp.float32(3.0))), want
    )


def _window_check(name, fold):
    """Tile windows (the sharded frame's per-device groups): each window's
    device-built queue, folded at its tile offset, reproduces its rows of
    the full grid."""
    v, t = _mesh(name)
    n = 64
    n_tiles = (n // vq.TILE_X) * (n // vq.TILE_Y)
    n_win = n_tiles // 4
    want = vq.voxelize_parity_queue(v, t, n)
    tiles = []
    for g in range(4):
        lo = jnp.int32(g * n_win)
        coefs, row0, count, ok = vq._build_queue_device(
            v, t, n, 128, 64, 4, 8, tile_lo=lo, n_win=n_win
        )
        assert bool(ok)
        tiles.append(_fold(fold)(coefs, row0, count, lo, n))
    got = vq._tiles_to_grid(jnp.concatenate(tiles), n)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("fold", FOLDS)
def test_queue_group_split(fold):
    _window_check("tet", fold)


@pytest.mark.parametrize("fold", FOLDS)
def test_queue_group_split_dense_queue(fold):
    """Dense multi-chunk runs must not leak across window boundaries."""
    _window_check("ico_dense", fold)


def test_static_voxelizer_multigroup():
    """StaticVoxelizer on the dense fixture with the platform's fold."""
    v, t = _mesh("ico_dense")
    n = 64
    sv = vq.StaticVoxelizer(v, t, n)
    np.testing.assert_array_equal(np.asarray(sv()), _oracle(v, t, n))


def test_suffix_parity_reference():
    """The jnp suffix-parity reference matches a brute-force bit loop (the
    in-kernel conversion implements the same recurrence)."""
    rng = np.random.default_rng(3)
    words = jnp.asarray(rng.integers(-2**31, 2**31, size=(4, 2, 8), dtype=np.int64).astype(np.int32))
    got = np.asarray(vq.suffix_parity_words(words)).astype(np.uint32)
    w = np.asarray(words).astype(np.uint32)
    for i in range(4):
        for lane in range(8):
            bits = np.concatenate([(w[i, t, lane] >> np.arange(32)) & 1 for t in range(2)])
            suf = np.cumsum(bits[::-1])[::-1] & 1  # parity of bits >= k
            expect = np.concatenate([suf[:32], suf[32:]])
            got_bits = np.concatenate([(got[i, t, lane] >> np.arange(32)) & 1 for t in range(2)])
            assert (got_bits == expect).all()


def test_deforming_multigroup_matches_static():
    """The deforming voxelizer (device build, platform fold) reproduces the
    host-layout static queue bit-for-bit, at rest and deformed."""
    v, t = _mesh("ico_dense")
    n = 64
    dv = vq.DeformingVoxelizer(v, t, n)
    w_static = np.asarray(vq.voxelize_parity_queue(v, t, n))
    np.testing.assert_array_equal(np.asarray(dv(v, check=True)), w_static)
    v2 = v * 1.03 + jnp.asarray([0.02, -0.03, 0.01])
    w2_static = np.asarray(vq.voxelize_parity_queue(v2, t, n))
    np.testing.assert_array_equal(np.asarray(dv(v2, check=True)), w2_static)


def test_kernel_and_plain_fold_agree_on_random_queue():
    """Both folds on the same built queue of a random triangle soup."""
    rng = np.random.default_rng(5)
    v = jnp.asarray(rng.uniform(-1.1, 1.1, size=(90, 3)), jnp.float32)
    t = jnp.asarray(rng.integers(0, 90, size=(60, 3)), jnp.int32)
    n = 64
    coefs, row0, count, _ = vq.build_queue(v, t, n)
    a = _fold("kernel")(coefs, row0, count, 0, n)
    b = _fold("xla")(coefs, row0, count, 0, n)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", [64, 256])
def test_queue_kernel_lowers_for_gpu(n):
    """The kernel lowers through Pallas' Triton route for the CUDA platform
    (lowering only: compiling needs the card)."""
    v, t = _mesh("box")
    coefs, row0, count, _ = vq.build_queue(v, t, n)
    lowered = jax.jit(partial(vq.queue_fold_triton, n=n)).trace(
        coefs, row0, count, jnp.int32(0)
    ).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()
