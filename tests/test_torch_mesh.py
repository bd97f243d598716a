"""The port's mesh and its collectives (``launch/mesh.py``,
``launch/collectives.py``) against numpy, on CPU shards.

Per-shard values are drawn with numpy; the expected result of each
collective is written out with explicit loops over mesh coordinates: a
group is the set of shards that agree on every axis outside the
collective's, ordered by the linear index over its axes, major to minor
in the order given (``jax.lax.axis_index``'s count).  Sums are checked
bitwise against numpy's sum in shard order, in float32.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.collectives import (
    P,
    Placed,
    all_gather,
    axis_index,
    place,
    place_zeros,
    pmax,
    psum,
    psum_scatter,
    shard,
    unshard,
)
from repro_torch.roofline.comm import CommCounter
from repro_torch.launch.mesh import Mesh, data_axes, make_host_mesh, make_mesh, shard_devices

MESHES = {"8": ((8,), ("data",)), "2x4": ((2, 4), ("data", "model"))}
AXES = {"8": ["data", ("data",)],
        "2x4": ["data", "model", ("data", "model"), ("model", "data")]}
CASES = [(m, a) for m in MESHES for a in AXES[m]]


def mesh_of(name):
    return make_host_mesh(*MESHES[name])


def coords(shape, k):
    return np.unravel_index(k, shape)


def expected_groups(shape, names, axes):
    """Per shard: (its linear index over ``axes``, the flat ids of its group
    in that index's order)."""
    axes = (axes,) if isinstance(axes, str) else axes
    pos = [names.index(a) for a in axes]
    n = int(np.prod(shape))
    lin = []
    for k in range(n):
        c, i = coords(shape, k), 0
        for p in pos:
            i = i * shape[p] + c[p]
        lin.append(i)
    out = []
    for k in range(n):
        ck = coords(shape, k)
        same = [j for j in range(n) if all(coords(shape, j)[d] == ck[d]
                                          for d in range(len(shape)) if d not in pos)]
        out.append((lin[k], sorted(same, key=lambda j: lin[j])))
    return out


def parts_of(mesh, shape=(4, 3), seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(mesh.size)]
    return xs, [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------------------
def test_mesh_layout_and_helpers():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.axis_names == ("data", "model")
    assert mesh.size == 8 and mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.flat_devices)
    assert mesh.coords(6) == {"data": 1, "model": 2}
    assert data_axes(mesh) == ("data",)
    assert data_axes(make_host_mesh((2, 2, 2), ("pod", "data", "model"))) == ("pod", "data")
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        Mesh([torch.device("cpu")] * 3, (2, 2), ("a", "b"))
    with pytest.raises(ValueError):
        Mesh([torch.device("cpu")] * 4, (2, 2), ("a", "a"))
    with pytest.raises(ValueError):
        mesh.axis_index("pod")


@pytest.mark.parametrize("mesh_name,axes", CASES)
def test_axis_index_and_groups(mesh_name, axes):
    shape, names = MESHES[mesh_name]
    mesh = mesh_of(mesh_name)
    want = expected_groups(shape, names, axes)
    assert axis_index(mesh, axes) == [lin for lin, _ in want]
    groups = mesh.groups(axes)
    for k, (_, group) in enumerate(want):
        assert group in groups


def test_axis_index_over_a_tuple_is_major_to_minor():
    mesh = mesh_of("2x4")
    assert axis_index(mesh, "model") == [0, 1, 2, 3] * 2
    assert axis_index(mesh, ("data", "model")) == list(range(8))
    assert axis_index(mesh, ("model", "data")) == [0, 2, 4, 6, 1, 3, 5, 7]


SPECS = {"8": [P("data"), P(None, "data"), P(("data",), None), P()],
         "2x4": [P("model", None), P(("data", "model")), P(("model", "data")),
                 P(None, "data"), P("data", "model"), P()]}


@pytest.mark.parametrize("mesh_name,spec", [(m, s) for m in SPECS for s in SPECS[m]],
                         ids=lambda v: str(v))
def test_shard_unshard_round_trip(mesh_name, spec):
    shape, names = MESHES[mesh_name]
    mesh = mesh_of(mesh_name)
    x = torch.arange(16 * 8 * 3, dtype=torch.float32).reshape(16, 8, 3)
    parts = shard(x, mesh, spec)
    assert len(parts) == mesh.size
    for k, part in enumerate(parts):
        c = dict(zip(names, coords(shape, k)))
        sl = [slice(None)] * 3
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            entry = (entry,) if isinstance(entry, str) else entry
            n, i = 1, 0
            for a in entry:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + c[a]
            size = x.shape[dim] // n
            sl[dim] = slice(i * size, (i + 1) * size)
        assert torch.equal(part, x[tuple(sl)])
        # on x's own device a block is a view of x, not a copy
        assert part.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert torch.equal(unshard(parts, mesh, spec), x)


def test_shard_refuses_what_does_not_divide():
    mesh = mesh_of("2x4")
    with pytest.raises(ValueError, match="not divisible"):
        shard(torch.zeros(6, 2), mesh, P("model"))
    with pytest.raises(ValueError, match="twice"):
        shard(torch.zeros(8, 8), mesh, P("model", "model"))


@pytest.mark.parametrize("mesh_name,axes", CASES)
def test_psum_and_pmax_match_numpy(mesh_name, axes):
    shape, names = MESHES[mesh_name]
    mesh = mesh_of(mesh_name)
    xs, ts = parts_of(mesh)
    sums, maxes = psum(ts, mesh, axes), pmax(ts, mesh, axes)
    for k, (_, group) in enumerate(expected_groups(shape, names, axes)):
        acc = xs[min(group)].copy()
        for j in sorted(group)[1:]:  # shard order
            acc = acc + xs[j]
        assert np.array_equal(sums[k].numpy(), acc)
        assert np.array_equal(maxes[k].numpy(), np.max([xs[j] for j in group], axis=0))


@pytest.mark.parametrize("mesh_name,axes", CASES)
@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather_matches_numpy(mesh_name, axes, tiled):
    shape, names = MESHES[mesh_name]
    mesh = mesh_of(mesh_name)
    xs, ts = parts_of(mesh)
    for axis in (0, 1):
        got = all_gather(ts, mesh, axes, axis=axis, tiled=tiled)
        join = np.concatenate if tiled else np.stack
        for k, (_, group) in enumerate(expected_groups(shape, names, axes)):
            assert np.array_equal(got[k].numpy(), join([xs[j] for j in group], axis=axis))


@pytest.mark.parametrize("mesh_name,axes", CASES)
def test_psum_scatter_matches_numpy(mesh_name, axes):
    shape, names = MESHES[mesh_name]
    mesh = mesh_of(mesh_name)
    n = mesh.axis_size(axes)
    xs, ts = parts_of(mesh, shape=(2 * n, 3))
    tiled = psum_scatter(ts, mesh, axes, scatter_dimension=0, tiled=True)
    xs1, ts1 = parts_of(mesh, shape=(3, n), seed=1)
    untiled = psum_scatter(ts1, mesh, axes, scatter_dimension=1)
    for k, (lin, group) in enumerate(expected_groups(shape, names, axes)):
        total, total1 = xs[min(group)].copy(), xs1[min(group)].copy()
        for j in sorted(group)[1:]:
            total, total1 = total + xs[j], total1 + xs1[j]
        assert np.array_equal(tiled[k].numpy(), total[2 * lin:2 * lin + 2])
        assert np.array_equal(untiled[k].numpy(), total1[:, lin])


def test_psum_scatter_then_psum_over_the_remaining_axes():
    """The shardmap scatter's pattern: reduce-scatter over the node axis,
    then a psum over the edge axes that are not node axes."""
    mesh = mesh_of("2x4")
    xs, ts = parts_of(mesh, shape=(8, 2))
    out = psum(psum_scatter(ts, mesh, "model", tiled=True), mesh, "data")
    per_data = [xs[4 * d] + xs[4 * d + 1] + xs[4 * d + 2] + xs[4 * d + 3] for d in (0, 1)]
    total = per_data[0] + per_data[1]  # each stage in shard order
    for k, i in enumerate(axis_index(mesh, "model")):
        assert np.array_equal(out[k].numpy(), total[2 * i:2 * i + 2])
        assert out[k] is out[(k + 4) % 8]  # one tensor per device, shared by the group


def test_collectives_are_differentiable():
    """Gradients through shard, psum, all_gather, psum_scatter and unshard
    are those of the same sums written on one tensor: row k of the result
    is 8 x the sum of the rows of k's data group."""
    mesh = mesh_of("2x4")
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    every = ("data", "model")
    summed = psum(shard(x, mesh, P(every)), mesh, "model")  # [1, 4] a shard
    gathered = all_gather(summed, mesh, every, axis=0, tiled=True)  # [8, 4]
    y = unshard(psum_scatter(gathered, mesh, every, tiled=True), mesh, P(every))
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    x1 = x.detach().clone().requires_grad_()
    y1 = 8 * x1.reshape(2, 4, 4).sum(dim=1).repeat_interleave(4, dim=0)
    (gx1,) = torch.autograd.grad((y1 * w).sum(), x1)
    np.testing.assert_allclose(y.detach().numpy(), y1.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), gx1.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_replicated_blocks_share_one_tensor_per_device(mesh_name):
    mesh = mesh_of(mesh_name)
    x = torch.arange(12.0).reshape(4, 3)
    parts = shard(x, mesh, P())
    assert all(p is parts[0] for p in parts) and parts[0] is x
    assert torch.equal(unshard(parts, mesh, P()), x)


# ---------------------------------------------------------------------------
# placement: state cut once, handed back by shard as it is
PLACE_SPECS = [P("model", None), P(None, ("data", "model")), P("data", "model"), P()]


@pytest.mark.parametrize("spec", PLACE_SPECS)
def test_shard_of_placed_returns_the_placed_tensors(spec):
    mesh = mesh_of("2x4")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32))
    placed = place(x, mesh, spec)
    with CommCounter() as c:
        parts = shard(placed, mesh, spec)
    assert all(p is q for p, q in zip(parts, placed.parts))
    assert c.stats()["counts"] == {} and c.stats()["bytes_by_op"] == {}
    # the blocks are copies of their own, equal to the per-call cut
    for got, want in zip(parts, shard(x, mesh, spec)):
        assert torch.equal(got, want) and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert torch.equal(unshard(parts, mesh, spec), x)
    # a spec spelled otherwise names the same layout; another layout raises
    assert shard(placed, mesh, P(*spec, None)) == parts
    with pytest.raises(ValueError, match="not placed"):
        shard(placed, mesh, P(None, "data") if spec != P(None, "data") else P("model"))
    with pytest.raises(ValueError, match="not placed"):
        shard(placed, make_host_mesh((2, 4), ("data", "model")), spec)


def test_placed_layers_casts_and_bytes():
    mesh = mesh_of("2x4")
    x = torch.arange(3 * 8 * 4, dtype=torch.float32).reshape(3, 8, 4)
    placed = place(x, mesh, P(None, "model"))
    assert isinstance(placed, Placed) and placed.shape == x.shape
    layer = placed[1]
    assert layer.shape == (8, 4) and layer.spec == P(("model",))
    assert torch.equal(unshard(shard(layer, mesh, P("model")), mesh, P("model")), x[1])
    assert placed.to(torch.float32) is placed
    half = layer.to(torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.parts[0].dtype == torch.bfloat16
    # shards that hold one block on one device share one tensor
    assert placed.nbytes == x.nbytes
    assert place(x, mesh, P()).nbytes == x.nbytes
    with pytest.raises(TypeError):
        place(torch.zeros(4, 8), mesh, P("data"))[0]


def test_place_zeros_and_write_at_slice_boundaries():
    """A placed [B, S, d] written at every position, across the S slices
    (size 2 over the 4 model shards), equals the whole tensor written the
    same way; each write lands in the one slice that owns its position."""
    mesh = mesh_of("2x4")
    spec = P("data", "model", None)
    placed = place_zeros((4, 8, 3), torch.float32, mesh, spec)
    assert [tuple(p.shape) for p in placed.parts] == [(2, 2, 3)] * 8
    whole = torch.zeros(4, 8, 3)
    rng = np.random.default_rng(4)
    for pos in (1, 2, 3, 4, 7, 0, 5, 6):
        new = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
        before = [p.clone() for p in placed.parts]
        placed.write(1, pos, new)
        whole[:, pos] = new
        changed = [k for k, (a, b) in enumerate(zip(before, placed.parts))
                   if not torch.equal(a, b)]
        owner = pos // 2
        assert changed == [k for k in range(8) if k % 4 == owner]
        assert torch.equal(unshard(placed.parts, mesh, spec), whole)


def test_shard_records_copies_to_another_device():
    """Only a copy to another device counts: a CPU tensor cut over CPU
    shards copies nothing; over shards on the meta device, every block."""
    with CommCounter() as c:
        shard(torch.zeros(8, 4), mesh_of("2x4"), P("model"))
    assert c.stats()["counts"] == {}
    meta = Mesh([torch.device("meta")] * 8, (2, 4), ("data", "model"))
    with CommCounter() as c:
        shard(torch.zeros(8, 4), meta, P("model"))
    st = c.stats()
    assert st["counts"] == {"shard-copy": 4} and st["bytes_by_op"] == {"shard-copy": 4 * 2 * 4 * 4}
    assert st["per_device_bytes"] == 0.0
