"""The port's CUDA kernels (K1-K10, Gray-Scott's raw step, the SOR kinds,
the ring exchange) against their plain versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (``nvcc``): the kernels are built
from ``mpi_cuda_process_tpu_torch/ops/cuda/csrc`` at first use.  Without a
card every test here skips.  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: ``32 * eps * max(|ref|, 1)``
for one raw step, ``rtol = atol = 1e-6`` for the compute_fn kernels,
``atol = 1e-4`` for k fused steps; frame cells exact; Life (int32, K7 and
K8), the streaming kernel (K10, against its plain version), every SOR
kind and the ring exchange (``ops/cuda/remote.py``, with its drained
counters read after every launch; and its cross-process form, ring_send
and ring_drain, on sites whose neighbours share this process) bit-equal.  The bfloat16 kinds of K1,
K2, Gray-Scott's raw step, K10 and the ring exchange are held to their
plain versions on bfloat16 tensors bit for bit (max |d| = 0): every op
rounds to bfloat16 as the plain op does; so are the bfloat16 kinds of K3
(RAW and PADDED), its shells, K6 and K9, K6 and K9's advection and
Gray-Scott kinds in float32, and the bfloat16 kinds of K4, K5, K7 and K8
(RAW and PADDED, with its overlap shells).
The sharded kernels (K3's sharded mode and its overlap shells, K6, K9,
K10, K8's sharded mode) run on meshes of virtual shards on one card.  Each
kernel's batched launch (an ensemble's members in one launch) is held to
its members' own launches and to its plain version at N = 3 (``-k
ensemble``).
"""

import numpy as np
import pytest
import torch

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import driver
from mpi_cuda_process_tpu_torch.ops.cuda import (fullgrid, fused, kernels,
                                                 rawstep, remote, streamfused)
from mpi_cuda_process_tpu_torch.parallel import (gather_fields, make_mesh,
                                                 make_sharded_fused_step,
                                                 make_sharded_step,
                                                 make_sharded_temporal_step,
                                                 shard_fields)

import compute_schedule  # noqa: E402  (tests/, on pytest's path)

pytestmark = pytest.mark.cuda

EPS32 = float(np.finfo(np.float32).eps)
SHAPES = [(32, 32, 128), (17, 19, 45)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fields(st, shape, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.rand(shape, generator=g, device=dev)
                 for _ in range(st.num_fields))


def _check(got, ref, halo, atol):
    frame = None if halo is None else driver.frame_mask(
        ref[0].shape, ref[0].shape, (0,) * ref[0].dim(), halo, ref[0].device)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        assert float((g - r).abs().max()) <= atol
        if frame is not None:
            assert torch.equal(g[frame], r[frame])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["heat3d", "heat3d27", "heat3d4th",
                                  "wave3d"])
def test_raw_step_kernel_matches_plain(dev, name, shape):
    st = port.make_stencil(name)
    fields = _fields(st, shape, dev, 1)
    ref = driver.make_step(st, shape)(fields)
    rawstep.launches.clear()
    got = rawstep.make_raw_step(st, shape, device=dev)(fields)
    torch.cuda.synchronize()
    wrapper = "raw_step_wave" if name == "wave3d" else "raw_step_heat"
    assert rawstep.launches[f"{wrapper}[{name}]"] == 1
    _check(got, ref, st.halo, 0.0)  # bit for bit (march.cuh, K1 and K2)
    if name == "wave3d":
        assert got[1] is fields[0]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d27", 4),
                                    ("heat3d4th", 2), ("wave3d", 8)])
def test_fused_kernel_matches_plain(dev, name, k, shape, periodic):
    st = port.make_stencil(name)
    fields = _fields(st, shape, dev, 2)
    plain = driver.make_step(st, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fused.launches.clear()
    got = fused.make_fused_step(st, shape, k, periodic=periodic,
                                device=dev)(fields)
    torch.cuda.synchronize()
    assert fused.launches[f"fused_step[{name}]"] == 1
    _check(got, ref, None if periodic else st.halo, 1e-4)


def test_wrappers_raise_on_operands_the_kernels_do_not_take(dev):
    st = port.make_stencil("heat3d")
    u = torch.rand(16, 16, 64, device=dev)
    # bfloat16 runs since the kernels gained its kind; float16 does not
    with pytest.raises(TypeError, match="float32"):
        rawstep.raw_step_heat(u.to(torch.float16), st)
    h = u.to(torch.float16)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused.fused_step((h,), st, 4)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused.fused_zslab((h[:8].contiguous(),), (h[:4].contiguous(),),
                          (h[:4].contiguous(),), st, 4, 16, 8)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused.fused_step((u, u.to(torch.bfloat16)), port.make_stencil(
            "wave3d"), 4)
    with pytest.raises(ValueError, match="contiguous"):
        rawstep.raw_step_heat(u.transpose(0, 2), st)
    with pytest.raises(ValueError, match="shape"):
        rawstep.raw_step_wave(u, u[:8].contiguous(),
                              port.make_stencil("wave3d"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["heat3d", "heat3d27", "heat3d4th",
                                  "wave3d"])
def test_compute_fn_kernel_matches_plain(dev, name, shape):
    """K4/K5 on a padded random block == the stencil's plain update."""
    st = port.make_stencil(name)
    h = st.halo
    padded = tuple(s + 2 * h for s in shape)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    p = torch.rand(padded, generator=g, device=dev)
    ins = (p,) if st.num_fields == 1 else (
        p, torch.rand(shape, generator=g, device=dev))
    ref = st.update(ins)[0]
    kernels.launches.clear()
    got = kernels.make_pallas_compute(st, device=dev)(ins)
    torch.cuda.synchronize()
    wrapper = "zchunk_wave" if name == "wave3d" else "zchunk_heat"
    assert kernels.launches[f"{wrapper}[{name}]"] == 1
    torch.testing.assert_close(got[0], ref, rtol=1e-6, atol=1e-6)
    if name == "wave3d":
        assert got[1] is ins[1]


SHARDED = [("heat3d", 4, (2, 2), None), ("heat3d27", 4, (2, 1), None),
           ("heat3d4th", 2, (2, 2), None), ("wave3d", 4, (2, 2), None),
           ("heat3d", 4, (4,), "padfree"), ("wave3d", 4, (2,), "padfree"),
           ("heat3d4th", 2, (4,), "padfree")]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name,k,mesh_shape,kind", SHARDED)
def test_sharded_fused_kernels_match_plain_sharded_steps(
        dev, name, k, mesh_shape, kind, periodic):
    """K3's sharded mode and K6 == k plain sharded steps, on a mesh of
    virtual shards on one card."""
    st = port.make_stencil(name)
    shape = (32, 24, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 4), mesh, 3)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fused.launches.clear()
    got = make_sharded_fused_step(st, mesh, shape, k, periodic=periodic,
                                  kind=kind, device=dev)(fields)
    torch.cuda.synchronize()
    wrapper = "fused_zslab" if kind else "fused_step_padded"
    assert fused.launches[f"{wrapper}[{name}]"] == mesh.size
    _check(gather_fields(got), gather_fields(ref),
           None if periodic else st.halo, 1e-4)


@pytest.mark.parametrize("name", ["heat3d", "heat3d27", "wave3d"])
def test_sharded_step_with_kernels_overlap_is_bit_equal(dev, name):
    """--mesh 2,2 --compute pallas: K4/K5 under the sharded step, with and
    without the overlap split (side stream), against the unsharded plain
    step; overlap equals non-overlap bit for bit."""
    st = port.make_stencil(name)
    shape = (32, 24, 40)
    mesh = make_mesh((2, 2), [dev] * 4)
    init = _fields(st, shape, dev, 5)
    ref = init
    for _ in range(3):
        ref = driver.make_step(st, shape)(ref)
    outs = []
    for overlap in (False, True):
        step = make_sharded_step(
            st, mesh, shape, overlap=overlap,
            compute_fn=kernels.make_pallas_compute(st, device=dev))
        got = shard_fields(init, mesh, 3)
        for _ in range(3):
            got = step(got)
        outs.append(gather_fields(got))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _check(outs[1], ref, st.halo, 1e-5)


def _pieces(shape, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("local,origins", [((24, 32, 40), (0, 0)),
                                           ((19, 21, 45), (19, 21))])
@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d27", 4),
                                    ("heat3d4th", 2), ("wave3d", 4)])
def test_yzslab_kernel_matches_plain(dev, name, k, local, origins, periodic):
    """K9 on a core and eight random pieces == plain_yzslab (the assembled
    window, k plain steps), at an aligned and a ragged shard of a
    (38, 42, X)-class grid."""
    st = port.make_stencil(name)
    m = k * st.halo
    Lz, Ly, X = local
    gshape = (2 * Lz, 2 * Ly, X)
    nf = st.num_fields
    seed = iter(range(100, 200))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)) for _ in range(nf))

    core = per_field(local)
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    ref = fused.plain_yzslab(core, zlo, zhi, ylo, yhi, corners, st, k,
                             gshape, origins, periodic)
    fused.launches.clear()
    got = fused.fused_yzslab(core, zlo, zhi, ylo, yhi, corners, st, k,
                             gshape, origins, periodic)
    torch.cuda.synchronize()
    assert fused.launches[f"fused_yzslab[{name}]"] == 1
    _check(got, ref, None, 1e-4)


@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d27", 4),
                                    ("heat3d4th", 2), ("wave3d", 4)])
@pytest.mark.parametrize("mesh_shape,kind", [
    ((2, 2), "padfree"), ((1, 4), "padfree"), ((2, 2), None),
    ((4,), "padfree")])
@pytest.mark.parametrize("periodic", [False, True])
def test_slab_kernels_and_overlap_shells_match_plain_sharded_steps(
        dev, mesh_shape, kind, name, k, periodic):
    """K9 (padfree on a mesh that shards y), K3's sharded mode and K6,
    each with and without the overlap shells, == k plain sharded steps on
    virtual shards; the overlapped step equals the non-split one bit for
    bit and launches one shell per sharded face of every shard."""
    st = port.make_stencil(name)
    shape = (48, 48, 40)  # local extents >= 3m on every sharded axis
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 9), mesh, 3)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    counts = mesh.counts(3)
    wrapper = ("fused_step_padded" if kind is None else
               "fused_yzslab" if counts[1] > 1 else "fused_zslab")
    faces = 2 * sum(c > 1 for c in counts[:2])
    outs = []
    for overlap in (False, True):
        fused.launches.clear()
        step = make_sharded_fused_step(st, mesh, shape, k, periodic=periodic,
                                       kind=kind, overlap=overlap,
                                       device=dev)
        assert step._overlap_active == overlap
        outs.append(gather_fields(step(fields)))
        torch.cuda.synchronize()
        want = {f"{wrapper}[{name}]": mesh.size}
        if overlap:
            want[f"fused_shell[{name}]"] = mesh.size * faces
        assert dict(fused.launches) == want
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _check(outs[0], gather_fields(ref), None if periodic else st.halo, 1e-4)


@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d4th", 2),
                                    ("wave3d", 4)])
def test_overlap_shell_kernel_matches_plain(dev, name, k):
    """A row-7 shell call (K3's sharded mode over a 2m-deep core, counted
    as fused_shell) == plain_step_padded on the same random strip."""
    st = port.make_stencil(name)
    m = k * st.halo
    local, gshape = (24, 30, 40), (48, 60, 40)
    shells = fused.build_overlap_shell_calls(st, local, gshape, k, (0, 1),
                                             device=dev)
    for d, org in ((0, (24 - 2 * m, 30)), (1, (24, 0))):
        pshape = [local[0] + 2 * m, local[1] + 2 * m, local[2]]
        pshape[d] = 4 * m
        strips = tuple(_pieces(tuple(pshape), dev, 7 + j)
                       for j in range(st.num_fields))
        ref = fused.plain_step_padded(strips, st, k, gshape, org)
        fused.launches.clear()
        got = shells[d](org, *strips)
        torch.cuda.synchronize()
        assert fused.launches[f"fused_shell[{name}]"] == 1
        _check(got, ref, None, 1e-4)


STREAM_FAMILIES = [("heat3d", 1), ("heat3d", 2), ("heat3d", 4),
                   ("heat3d27", 4), ("heat3d4th", 1), ("heat3d4th", 2),
                   ("wave3d", 1), ("wave3d", 4)]


@pytest.mark.parametrize("shape", SHAPES + [(68, 76, 130)])
@pytest.mark.parametrize("name,k", STREAM_FAMILIES)
def test_stream_kernel_matches_plain(dev, name, k, shape):
    """K10 over the whole grid (row 16) == k plain steps, bit for bit."""
    st = port.make_stencil(name)
    fields = _fields(st, shape, dev, 3)
    ref = fused.plain_steps(fields, st, k)
    streamfused.launches.clear()
    got = streamfused.make_stream_fused_step(st, shape, k, device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(streamfused.launches) == {f"stream_step[{name}]": 1}
    _check(got, ref, st.halo, 0.0)
    with pytest.raises(TypeError, match="float32"):
        streamfused.stream_step(tuple(f.to(torch.float16) for f in fields),
                                st, k)


@pytest.mark.parametrize("local,origins", [((24, 32, 40), (0, 0)),
                                           ((19, 21, 45), (19, 21)),
                                           ((19, 21, 45), (38, 42))])
@pytest.mark.parametrize("name,k", STREAM_FAMILIES)
def test_stream_slab_kernels_match_plain(dev, name, k, local, origins):
    """K10 over a z-only shard (row 17) and over a shard of a mesh that
    shards y (row 18), on a core and random slabs and corners, at a low
    wall, an interior and a high wall shard of a 3x3 grid of shards ==
    their plain versions (plain_zslab, plain_yzslab), bit for bit."""
    st = port.make_stencil(name)
    m = k * st.halo
    Lz, Ly, X = local
    gshape = (3 * Lz, 3 * Ly, X)
    nf = st.num_fields
    seed = iter(range(300, 400))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)) for _ in range(nf))

    core = per_field(local)
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    streamfused.launches.clear()
    zcall, zm, _ = streamfused.build_stream_sharded_call(
        st, local, (gshape[0], Ly, X), k, device=dev)
    args = [t for fs in zip(core, zlo, zhi) for t in fs]
    got = zcall(origins[0], *args)
    ref = fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], origins[0])
    torch.cuda.synchronize()
    assert zm == m
    _check(got, ref, None, 0.0)
    yzcall, _, _ = streamfused.build_stream_2axis_call(st, local, gshape, k,
                                                       device=dev)
    args = [t for fs in zip(core, zlo, zhi, ylo, yhi, *corners) for t in fs]
    got = yzcall(origins, *args)
    ref = fused.plain_yzslab(core, zlo, zhi, ylo, yhi, corners, st, k,
                             gshape, origins)
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    assert dict(streamfused.launches) == {f"stream_zslab[{name}]": 1,
                                          f"stream_yzslab[{name}]": 1}


@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d27", 4),
                                    ("heat3d4th", 2), ("wave3d", 4)])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4,)])
def test_stream_sharded_steps_match_plain_sharded_steps(dev, mesh_shape,
                                                        name, k):
    """kind="stream" (K10 on z slabs or the 2-axis slab set), with and
    without the overlap shells, == k plain sharded steps on virtual
    shards; the overlapped step equals the non-split one bit for bit."""
    st = port.make_stencil(name)
    shape = (48, 48, 40)  # local extents >= 3m on every sharded axis
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 11), mesh, 3)
    plain = make_sharded_step(st, mesh, shape)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    counts = mesh.counts(3)
    wrapper = "stream_yzslab" if counts[1] > 1 else "stream_zslab"
    faces = 2 * sum(c > 1 for c in counts[:2])
    outs = []
    for overlap in (False, True):
        streamfused.launches.clear()
        fused.launches.clear()
        step = make_sharded_fused_step(st, mesh, shape, k, kind="stream",
                                       overlap=overlap, device=dev)
        assert step._overlap_active == overlap
        assert step._padfree_kind == ("stream_yz" if counts[1] > 1
                                      else "stream_z")
        outs.append(gather_fields(step(fields)))
        torch.cuda.synchronize()
        assert dict(streamfused.launches) == {f"{wrapper}[{name}]":
                                              mesh.size}
        assert dict(fused.launches) == (
            {f"fused_shell[{name}]": mesh.size * faces} if overlap else {})
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _check(outs[0], gather_fields(ref), st.halo, 1e-4)


SHAPES_2D = [(128, 256), (130, 258), (1000, 777)]


def _fields_2d(st, shape, dev, seed):
    """Random occupancy (Life) or uniform floats on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if st.name == "life":
        return ((torch.rand(shape, generator=g, device=dev) < 0.35)
                .to(torch.int32),)
    return tuple(torch.rand(shape, generator=g, device=dev)
                 for _ in range(st.num_fields))


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name", ["life", "heat2d"])
def test_whole2d_kernel_matches_plain(dev, name, shape):
    """K7 on a padded random block == the stencil's plain update (Life
    exactly, heat2d within 1e-6)."""
    st = port.make_stencil(name)
    p = _fields_2d(st, tuple(s + 2 for s in shape), dev, 6)
    ref = st.update(p)[0]
    kernels.launches.clear()
    got = kernels.make_pallas_compute(st, device=dev)(p)[0]
    torch.cuda.synchronize()
    assert kernels.launches[f"whole2d[{name}]"] == 1
    if name == "life":
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name,k", [("life", 1), ("life", 8), ("life", 20),
                                    ("heat2d", 4), ("wave2d", 8)])
def test_fullgrid_kernel_matches_plain(dev, name, k, shape, periodic):
    """K8 on the whole grid == k plain steps; k = 20 takes two launches."""
    st = port.make_stencil(name)
    fields = _fields_2d(st, shape, dev, 7)
    plain = driver.make_step(st, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                      device=dev)(fields)
    torch.cuda.synchronize()
    assert fullgrid.launches[f"fullgrid_step[{name}]"] == \
        -(-k // fullgrid.K_PER_LAUNCH)
    _check(got, ref, None if periodic else st.halo,
           0 if name == "life" else 1e-4)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name,n", [("life", 2), ("life", 4),
                                    ("heat2d", 4), ("wave2d", 2)])
def test_sharded_fullgrid_kernel_matches_plain_sharded_steps(
        dev, name, n, periodic, overlap):
    """K8's sharded mode (and its overlap shells) == k plain sharded steps
    on a row split of virtual shards on one card."""
    st = port.make_stencil(name)
    shape, k = (192, 200), 8
    mesh = make_mesh((n,), [dev] * 4)
    fields = shard_fields(_fields_2d(st, shape, dev, 8), mesh, 2)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    step = make_sharded_temporal_step(st, mesh, shape, k, periodic=periodic,
                                      overlap=overlap, device=dev)
    got = step(fields)
    torch.cuda.synchronize()
    assert step._overlap_active == overlap
    assert fullgrid.launches[f"fullgrid_padded[{name}]"] == \
        mesh.size * (3 if overlap else 1)
    _check(gather_fields(got), gather_fields(ref),
           None if periodic else st.halo, 0 if name == "life" else 1e-4)


# ---------------------------------------------------------------------------
# advection and Gray-Scott: K1 raw_step_heat[advect3d], raw_step_grayscott,
# K3 fused_step / fused_step_padded / fused_shell, K8 fullgrid_step /
# fullgrid_padded
# ---------------------------------------------------------------------------

NEW_3D = [("advect3d", {}), ("advect3d", {"cx": 0.3, "cy": -0.2, "cz": 0.25}),
          ("advect3d", {"cx": -0.3, "cy": 0.0, "cz": -0.45}),
          ("grayscott3d", {})]
NEW_2D = [("advect2d", {}), ("advect2d", {"cx": -0.4, "cy": 0.2}),
          ("advect2d", {"cx": 0.0, "cy": -0.5}), ("grayscott2d", {})]


def _ids(cases):
    return [n + "".join(f"-{k}{v}" for k, v in kw.items()) for n, kw in cases]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", NEW_3D, ids=_ids(NEW_3D))
def test_new_raw_step_kernels_match_plain(dev, name, kw, shape):
    """K1's advection kind and the Gray-Scott raw step == one plain step,
    bit for bit, both fields, frame cells exact."""
    st = port.make_stencil(name, **kw)
    fields = _fields(st, shape, dev, 11)
    ref = driver.make_step(st, shape)(fields)
    rawstep.launches.clear()
    got = rawstep.make_raw_step(st, shape, device=dev)(fields)
    torch.cuda.synchronize()
    wrapper = "raw_step_grayscott" if name == "grayscott3d" \
        else "raw_step_heat"
    assert dict(rawstep.launches) == {f"{wrapper}[{name}]": 1}
    assert len(got) == st.num_fields
    _check(got, ref, st.halo, 0.0)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", NEW_3D, ids=_ids(NEW_3D))
def test_new_fused_kernels_match_plain(dev, name, kw, shape, k, periodic):
    """K3 for advection and Gray-Scott (four window buffers) == k plain
    steps; the wrapper takes any k whose window fits."""
    st = port.make_stencil(name, **kw)
    fields = _fields(st, shape, dev, 12)
    plain = driver.make_step(st, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fused.launches.clear()
    got = fused.fused_step(fields, st, k, periodic=periodic)
    torch.cuda.synchronize()
    assert dict(fused.launches) == {f"fused_step[{name}]": 1}
    _check(got, ref, None if periodic else st.halo, 1e-4)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4,)])
@pytest.mark.parametrize("name,kw", NEW_3D, ids=_ids(NEW_3D))
def test_new_sharded_fused_kernels_match_plain_sharded_steps(
        dev, name, kw, mesh_shape, periodic, overlap):
    """K3's sharded mode for the two families (both Gray-Scott fields from
    their padded blocks), with the overlap shells, == k plain sharded
    steps; overlap equals non-overlap bit for bit."""
    st = port.make_stencil(name, **kw)
    shape, k = (48, 48, 40), 4
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 13), mesh, 3)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fused.launches.clear()
    step = make_sharded_fused_step(st, mesh, shape, k, periodic=periodic,
                                   overlap=overlap, device=dev)
    got = step(fields)
    torch.cuda.synchronize()
    assert step._overlap_active == overlap
    faces = 2 * sum(c > 1 for c in mesh.counts(3)[:2])
    want = {f"fused_step_padded[{name}]": mesh.size}
    if overlap:
        want[f"fused_shell[{name}]"] = mesh.size * faces
    assert dict(fused.launches) == want
    _check(gather_fields(got), gather_fields(ref),
           None if periodic else st.halo, 1e-4)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 20])
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name,kw", NEW_2D, ids=_ids(NEW_2D))
def test_new_fullgrid_kernels_match_plain(dev, name, kw, shape, k, periodic):
    """K8 for advect2d and grayscott2d (four buffers) == k plain steps."""
    st = port.make_stencil(name, **kw)
    fields = _fields_2d(st, shape, dev, 14)
    plain = driver.make_step(st, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                      device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(fullgrid.launches) == {
        f"fullgrid_step[{name}]": -(-k // fullgrid.K_PER_LAUNCH)}
    _check(got, ref, None if periodic else st.halo, 1e-4)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name,kw", NEW_2D, ids=_ids(NEW_2D))
def test_new_sharded_fullgrid_kernels_match_plain_sharded_steps(
        dev, name, kw, n, periodic, overlap):
    st = port.make_stencil(name, **kw)
    shape, k = (192, 200), 8
    mesh = make_mesh((n,), [dev] * 4)
    fields = shard_fields(_fields_2d(st, shape, dev, 15), mesh, 2)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    step = make_sharded_temporal_step(st, mesh, shape, k, periodic=periodic,
                                      overlap=overlap, device=dev)
    got = step(fields)
    torch.cuda.synchronize()
    assert step._overlap_active == overlap
    assert dict(fullgrid.launches) == {
        f"fullgrid_padded[{name}]": mesh.size * (3 if overlap else 1)}
    _check(gather_fields(got), gather_fields(ref),
           None if periodic else st.halo, 1e-4)


# ---------------------------------------------------------------------------
# red-black SOR: the SOR kinds of K3 (fused_step, fused_step_padded and the
# fused_shell shells), K6, K9, K10 (stream_step, stream_zslab,
# stream_yzslab) and K8 (fullgrid_step, fullgrid_padded), each bit-equal to
# its plain version (red and black half-sweeps of the port's ops/sor.py)
# ---------------------------------------------------------------------------

SOR_SHAPES = [(32, 32, 128), (18, 20, 46), (17, 19, 45)]
SOR_SHAPES_2D = [(128, 256), (130, 258), (101, 77)]


def _even(shape):
    return not any(s % 2 for s in shape)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SOR_SHAPES)
def test_sor_fused_kernel_matches_plain(dev, shape, k, periodic):
    """K3's SOR kind (2k one-colour half-sweeps, margin 2k) == k plain
    red-black steps, bit for bit; odd and even k, guard frame and (over
    even extents) periodic."""
    if periodic and not _even(shape):
        pytest.skip("a periodic wrap over an odd extent is refused for SOR")
    st = port.make_stencil("sor3d")
    fields = _fields(st, shape, dev, 21)
    ref = fused.plain_steps(fields, st, k, periodic)
    fused.launches.clear()
    got = fused.fused_step(fields, st, k, periodic=periodic)
    torch.cuda.synchronize()
    assert dict(fused.launches) == {"fused_step[sor3d]": 1}
    _check(got, ref, None if periodic else 1, 0.0)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mesh_shape,kind", [
    ((2, 2), None), ((4, 1), None), ((4,), "padfree"), ((2, 2), "padfree"),
    ((1, 4), "padfree")])
def test_sor_sharded_fused_kernels_match_plain_sharded_steps(
        dev, mesh_shape, kind, k, periodic, overlap):
    """K3's sharded mode, K6 and K9 for SOR, with and without the overlap
    shells, == k plain red-black sharded steps (each half-sweep with its own
    exchange), bit for bit; overlap equals non-overlap."""
    st = port.make_stencil("sor3d")
    shape = (48, 48, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 22), mesh, 3)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    counts = mesh.counts(3)
    m = 2 * k
    split = all(shape[d] // counts[d] >= 3 * m for d in (0, 1)
                if counts[d] > 1)
    wrapper = ("fused_step_padded" if kind is None else
               "fused_yzslab" if counts[1] > 1 else "fused_zslab")
    fused.launches.clear()
    step = make_sharded_fused_step(st, mesh, shape, k, periodic=periodic,
                                   kind=kind, overlap=overlap, device=dev)
    got = gather_fields(step(fields))
    torch.cuda.synchronize()
    assert step._overlap_active == (overlap and split)
    want = {f"{wrapper}[sor3d]": mesh.size}
    if overlap and split:
        faces = 2 * sum(c > 1 for c in counts[:2])
        want["fused_shell[sor3d]"] = mesh.size * faces
    assert dict(fused.launches) == want
    _check(got, gather_fields(ref), None if periodic else 1, 0.0)


@pytest.mark.parametrize("k", [2, 4])
def test_sor_overlap_shell_kernel_matches_plain(dev, k):
    """A SOR shell (K3's sharded mode over a 2m-deep core, m = 2k) ==
    plain_step_padded on the same random strip, at shell origins of both
    coordinate-sum parities."""
    st = port.make_stencil("sor3d")
    m = 2 * k
    local, gshape = (24, 30, 40), (48, 60, 40)
    shells = fused.build_overlap_shell_calls(st, local, gshape, k, (0, 1),
                                             device=dev)
    for d, org in ((0, (24 - 2 * m, 30)), (1, (24, 0)), (1, (24, 31))):
        pshape = [local[0] + 2 * m, local[1] + 2 * m, local[2]]
        pshape[d] = 4 * m
        strip = (_pieces(tuple(pshape), dev, 23 + d),)
        ref = fused.plain_step_padded(strip, st, k, gshape, org)
        fused.launches.clear()
        got = shells[d](org, *strip)
        torch.cuda.synchronize()
        assert dict(fused.launches) == {"fused_shell[sor3d]": 1}
        _check(got, ref, None, 0.0)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SOR_SHAPES)
def test_sor_stream_kernel_matches_plain(dev, shape, k):
    """K10's SOR kind (2k levels of halo 1) over the whole grid == k plain
    red-black steps, bit for bit."""
    st = port.make_stencil("sor3d")
    fields = _fields(st, shape, dev, 24)
    ref = fused.plain_steps(fields, st, k)
    streamfused.launches.clear()
    got = streamfused.make_stream_fused_step(st, shape, k, device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(streamfused.launches) == {"stream_step[sor3d]": 1}
    _check(got, ref, 1, 0.0)


@pytest.mark.parametrize("local,origins", [((24, 32, 40), (0, 0)),
                                           ((20, 22, 45), (20, 22)),
                                           ((19, 21, 45), (38, 21))])
@pytest.mark.parametrize("k", [2, 4])
def test_sor_stream_slab_kernels_match_plain(dev, k, local, origins):
    """K10's SOR kind over a z-only shard and over a shard of a mesh that
    shards y, on random slabs and corners, at origins of both parities ==
    plain_zslab and plain_yzslab, bit for bit."""
    st = port.make_stencil("sor3d")
    m = 2 * k
    Lz, Ly, X = local
    gshape = (3 * Lz, 3 * Ly, X)
    seed = iter(range(500, 600))

    def one(shape):
        return (_pieces(shape, dev, next(seed)),)

    core = one(local)
    zlo, zhi = one((m, Ly, X)), one((m, Ly, X))
    ylo, yhi = one((Lz, m, X)), one((Lz, m, X))
    corners = [one((m, m, X)) for _ in range(4)]
    streamfused.launches.clear()
    got = streamfused.stream_zslab(core, zlo, zhi, st, k, gshape[0],
                                   origins[0])
    ref = fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], origins[0])
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    args = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, origins)
    got = streamfused.stream_yzslab(*args)
    ref = fused.plain_yzslab(*args)
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    assert dict(streamfused.launches) == {"stream_zslab[sor3d]": 1,
                                          "stream_yzslab[sor3d]": 1}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4,)])
def test_sor_stream_sharded_steps_match_plain_sharded_steps(dev, mesh_shape,
                                                            k):
    """kind="stream" for SOR, with and without the overlap shells, == k
    plain red-black sharded steps, bit for bit."""
    st = port.make_stencil("sor3d")
    shape = (48, 48, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 25), mesh, 3)
    plain = make_sharded_step(st, mesh, shape)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    counts = mesh.counts(3)
    split = all(shape[d] // counts[d] >= 6 * k for d in (0, 1)
                if counts[d] > 1)
    wrapper = "stream_yzslab" if counts[1] > 1 else "stream_zslab"
    outs = []
    for overlap in (False, True):
        streamfused.launches.clear()
        step = make_sharded_fused_step(st, mesh, shape, k, kind="stream",
                                       overlap=overlap, device=dev)
        assert step._overlap_active == (overlap and split)
        outs.append(gather_fields(step(fields)))
        torch.cuda.synchronize()
        assert dict(streamfused.launches) == {f"{wrapper}[sor3d]": mesh.size}
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _check(outs[0], gather_fields(ref), 1, 0.0)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 20])
@pytest.mark.parametrize("shape", SOR_SHAPES_2D)
def test_sor_fullgrid_kernel_matches_plain(dev, shape, k, periodic):
    """K8's SOR kind on the whole grid == k plain red-black steps, bit for
    bit; a launch takes 8 steps (16 half-sweeps), so k = 20 takes three."""
    if periodic and not _even(shape):
        pytest.skip("a periodic wrap over an odd extent is refused for SOR")
    st = port.make_stencil("sor2d")
    fields = _fields_2d(st, shape, dev, 26)
    ref = fused.plain_steps(fields, st, k, periodic)
    fullgrid.launches.clear()
    got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                      device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(fullgrid.launches) == {"fullgrid_step[sor2d]": -(-k // 8)}
    _check(got, ref, None if periodic else 1, 0.0)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_sor_sharded_fullgrid_kernel_matches_plain_sharded_steps(
        dev, n, k, periodic, overlap):
    """K8's sharded mode for sor2d (margin 2k) and its overlap shells == k
    plain red-black sharded steps on a row split, bit for bit."""
    st = port.make_stencil("sor2d")
    shape = (192, 200)
    mesh = make_mesh((n,), [dev] * 4)
    fields = shard_fields(_fields_2d(st, shape, dev, 27), mesh, 2)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    step = make_sharded_temporal_step(st, mesh, shape, k, periodic=periodic,
                                      overlap=overlap, device=dev)
    got = step(fields)
    torch.cuda.synchronize()
    assert step._overlap_active == overlap
    assert dict(fullgrid.launches) == {
        "fullgrid_padded[sor2d]": mesh.size * (3 if overlap else 1)}
    _check(gather_fields(got), gather_fields(ref),
           None if periodic else 1, 0.0)


# ---- K10's advection and Gray-Scott kinds -----------------------------------

def _new_family(label):
    """advect3d with Courant numbers of both signs, or a registry name."""
    if label == "advect3d-mixed":
        return port.make_stencil("advect3d", cx=-0.3, cy=0.2, cz=-0.25)
    return port.make_stencil(label)


NEW_STREAM = ["advect3d", "advect3d-mixed", "grayscott3d"]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES + [(68, 76, 130)])
@pytest.mark.parametrize("label", NEW_STREAM)
def test_stream_new_kinds_match_plain(dev, label, shape, k):
    """K10's ADVECT and GRAYSCOTT kinds over the whole grid (row 16) == k
    plain steps, bit for bit (Gray-Scott: rings for u and v at every
    level)."""
    st = _new_family(label)
    fields = _fields(st, shape, dev, 31)
    ref = fused.plain_steps(fields, st, k)
    streamfused.launches.clear()
    got = streamfused.make_stream_fused_step(st, shape, k, device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(streamfused.launches) == {f"stream_step[{st.name}]": 1}
    _check(got, ref, st.halo, 0.0)


@pytest.mark.parametrize("local,origins", [((24, 32, 40), (0, 0)),
                                           ((19, 21, 45), (19, 21)),
                                           ((19, 21, 45), (38, 42))])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("label", NEW_STREAM)
def test_stream_new_kinds_slab_kernels_match_plain(dev, label, k, local,
                                                   origins):
    """K10's new kinds over a z-only shard (row 17) and a shard of a mesh
    that shards y (row 18), on random slabs and corners == plain_zslab and
    plain_yzslab, bit for bit."""
    st = _new_family(label)
    m = k
    Lz, Ly, X = local
    gshape = (3 * Lz, 3 * Ly, X)
    seed = iter(range(700, 800))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed))
                     for _ in range(st.num_fields))

    core = per_field(local)
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    streamfused.launches.clear()
    got = streamfused.stream_zslab(core, zlo, zhi, st, k, gshape[0],
                                   origins[0])
    ref = fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], origins[0])
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    args = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, origins)
    got = streamfused.stream_yzslab(*args)
    ref = fused.plain_yzslab(*args)
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    assert dict(streamfused.launches) == {f"stream_zslab[{st.name}]": 1,
                                          f"stream_yzslab[{st.name}]": 1}


# ---- the ring exchange (row 19) ---------------------------------------------

def _ring(mesh, axis):
    """(nxt, prv): each shard's next and previous neighbour along axis."""
    n = mesh.counts(3)[axis]
    coords = list(mesh.coords())

    def shifted(c, s):
        c = list(c)
        c[axis] = (c[axis] + s) % n
        return mesh.index(c)

    return [shifted(c, 1) for c in coords], [shifted(c, -1) for c in coords]


# (4, 64, 128): four y chunks of strided runs (float4 units); (24, 4, 128)
# and (4, 4, 128): four z chunks; (3, 5, 130): one chunk, float units
RING_SHAPES = [(4, 64, 128), (24, 4, 128), (4, 4, 128), (3, 5, 130)]


@pytest.mark.parametrize("nslots,prefer_nc", [(2, 0), (3, 0), (4, 0), (2, 8)])
@pytest.mark.parametrize("shape", RING_SHAPES)
@pytest.mark.parametrize("mesh_shape", [(4,), (1, 4), (2, 2)])
def test_ring_exchange_kernel_matches_plain(dev, mesh_shape, shape, nslots,
                                            prefer_nc):
    """ring_exchange on every sharded axis of a mesh of virtual shards ==
    plain_ring_exchange and the ring shift itself, bit for bit, three
    launches back to back, every counter drained after each."""
    mesh = make_mesh(mesh_shape, [dev] * 4)
    for axis in (0, 1):
        if mesh.counts(3)[axis] == 1:
            continue
        nxt, prv = _ring(mesh, axis)
        hi = [_pieces(shape, dev, 900 + i) for i in range(4)]
        lo = [_pieces(shape, dev, 950 + i) for i in range(4)]
        call, meta = remote.build_ring_exchange_call(
            shape, torch.float32, nslots=nslots, prefer_nc=prefer_nc,
            device=dev)
        assert (meta["chunk_axis"], meta["nchunks"]) == remote.pick_chunks(
            shape, 4, nslots, prefer_nc)
        plain_state = remote.RingState(meta, 4, "cpu")
        ref = remote.plain_ring_exchange([h.cpu() for h in hi],
                                         [x.cpu() for x in lo], nxt, prv,
                                         meta, plain_state)
        key = f"ring_exchange[{'x'.join(map(str, shape))}]"
        for _ in range(3):
            remote.launches.clear()
            got = call(hi, lo, nxt, prv)
            torch.cuda.synchronize()
            assert dict(remote.launches) == {key: 1}
            call.state.check_drained(meta)
            for i in range(4):
                assert torch.equal(got[0][i].cpu(), ref[0][i])
                assert torch.equal(got[1][i].cpu(), ref[1][i])
                assert torch.equal(got[0][i], hi[prv[i]])
                assert torch.equal(got[1][i], lo[nxt[i]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RING_SHAPES)
@pytest.mark.parametrize("mesh_shape", [(4,), (1, 4), (2, 2)])
def test_peer_ring_kernels_match_plain(dev, mesh_shape, shape, dtype):
    """ring_send and ring_drain (the ring across processes) on a site
    whose neighbours all live in this process: five epochs on two slots,
    each drain == the plain peer ring (the host walking the same protocol
    over a region tensor) == the ring shift, bit for bit, one launch of
    each a shift; every flag and credit at the last epoch."""
    mesh = make_mesh(mesh_shape, [dev] * 4)
    for axis in (0, 1):
        if mesh.counts(3)[axis] == 1:
            continue
        nxt, prv = _ring(mesh, axis)
        to = [((0, nxt[i]), (0, prv[i])) for i in range(4)]
        frm = [((0, prv[i]), (0, nxt[i])) for i in range(4)]
        _, meta = remote.build_ring_exchange_call(shape, dtype, device=dev)
        site = remote.PeerSite(meta, mesh, to, frm, dev)
        plain = remote.PeerSite(meta, mesh, to, frm, dev, regions=[
            torch.zeros(remote.peer_layout(meta, 4, 1)["bytes"],
                        dtype=torch.uint8, device=dev)])
        name = "x".join(map(str, shape))
        for e in range(1, 6):
            hi = [_pieces(shape, dev, 10 * e + i).to(dtype)
                  for i in range(4)]
            lo = [_pieces(shape, dev, 50 * e + i).to(dtype)
                  for i in range(4)]
            remote.launches.clear()
            got = site.drain(site.post(hi, lo))
            torch.cuda.synchronize()
            assert sorted(remote.launches.values()) == [1, 1]
            assert set(remote.launches) == {
                remote._build.launch_key(w, name, hi[0])
                for w in ("ring_send", "ring_drain")}
            ref = plain.drain(plain.post(hi, lo))
            for i in range(4):
                assert torch.equal(got[0][i], ref[0][i])
                assert torch.equal(got[1][i], ref[1][i])
                assert torch.equal(got[0][i], hi[prv[i]])
                assert torch.equal(got[1][i], lo[nxt[i]])
        site.check_drained()
        plain.check_drained()
    remote.free_peer_regions()


def test_peer_ring_drain_past_its_deadline_raises(dev):
    """A drain of an epoch nobody sent returns at its deadline, records
    the site, epoch, chunk and peer, and the next check raises; cleared,
    the site runs on."""
    shape = (4, 64, 128)
    _, meta = remote.build_ring_exchange_call(shape, torch.float32,
                                              device=dev)
    one = make_mesh((1,), [dev])
    site = remote.PeerSite(meta, one, [((0, 0), (0, 0))],
                           [((0, 0), (0, 0))], dev, timeout_s=0.2)
    site._launch(1, 1, None, torch.empty((1, 2) + shape, device=dev))
    torch.cuda.synchronize()
    with pytest.raises(remote.PeerTimeout, match="epoch 1.*process 0"):
        site.check()
    remote.reset_peer_record(dev)
    hi = [_pieces(shape, dev, 3)]
    got = site.drain(site.post(hi, hi))
    assert torch.equal(got[0][0], hi[0]) and torch.equal(got[1][0], hi[0])
    remote.free_peer_regions()


def test_ring_exchange_refuses_bf16_and_unknown_rings(dev):
    """bfloat16 slabs run since the kernel gained its 2-byte unit
    (test_bf16_ring_exchange_matches_plain); other types and rings that
    are not permutations are refused."""
    shape = (4, 64, 128)
    remote.build_ring_exchange_call(shape, torch.bfloat16, device=dev)
    call, _ = remote.build_ring_exchange_call(shape, torch.float32,
                                              device=dev)
    slabs = [_pieces(shape, dev, i) for i in range(2)]
    with pytest.raises(TypeError, match="float32"):
        call([s.to(torch.float16) for s in slabs],
             [s.to(torch.float16) for s in slabs], [1, 0], [1, 0])
    with pytest.raises(ValueError, match="inverse permutations"):
        call(slabs, slabs, [0, 0], [1, 0])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4,)])
@pytest.mark.parametrize("name,k", [("heat3d", 4), ("wave3d", 4),
                                    ("advect3d", 4), ("grayscott3d", 4),
                                    ("sor3d", 2)])
def test_rdma_sharded_step_matches_ppermute(dev, name, k, mesh_shape,
                                            overlap):
    """make_sharded_fused_step(kind="stream", exchange="rdma") == the same
    step with the in-process exchange, bit for bit, two calls; the ring
    kernel carried every sharded axis's exchange."""
    st = port.make_stencil(name)
    shape = (48, 48, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(_fields(st, shape, dev, 41), mesh, 3)
    outs = []
    for exchange in ("ppermute", "rdma"):
        step = make_sharded_fused_step(st, mesh, shape, k, kind="stream",
                                       overlap=overlap, exchange=exchange,
                                       device=dev)
        assert step._overlap_active == overlap
        remote.launches.clear()
        f = fields
        for _ in range(2):
            f = step(f)
        outs.append(gather_fields(f))
        torch.cuda.synchronize()
        if exchange == "rdma":
            assert step._rdma_backend == "cuda-ring"
            assert sum(remote.launches.values()) > 0
        else:
            assert not remote.launches
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- bfloat16: K1, K2, Gray-Scott's raw step, K10, the ring ----------------

BF16 = torch.bfloat16
RAW_BF16 = ["heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
            "grayscott3d"]


def _bf16_stencil(name):
    if name == "advect3d":  # both upwind directions
        return port.make_stencil(name, cx=-0.3, cy=0.2, cz=-0.25,
                                 dtype="bfloat16")
    return port.make_stencil(name, dtype="bfloat16")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RAW_BF16)
def test_bf16_raw_step_kernel_matches_plain(dev, name, shape):
    """The bfloat16 kinds of K1 (four tap sets), K2 and raw_step_grayscott
    == the plain bfloat16 step, bit for bit, two steps."""
    st = _bf16_stencil(name)
    fields = tuple(f.to(BF16) for f in _fields(st, shape, dev, 51))
    plain = driver.make_step(st, shape)
    raw = rawstep.make_raw_step(st, shape, device=dev)
    ref, got = fields, fields
    rawstep.launches.clear()
    for _ in range(2):
        ref, got = plain(ref), raw(got)
    torch.cuda.synchronize()
    assert sum(rawstep.launches.values()) == 2
    assert all(key.endswith(",bfloat16]") for key in rawstep.launches)
    _check(got, ref, st.halo, 0.0)


BF16_STREAM = [("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
               ("wave3d", 1), ("wave3d", 4), ("advect3d", 4),
               ("grayscott3d", 4), ("sor3d", 2), ("heat3d", 8)]


@pytest.mark.parametrize("shape", SHAPES + [(68, 76, 130)])
@pytest.mark.parametrize("name,k", BF16_STREAM)
def test_bf16_stream_kernel_matches_plain(dev, name, k, shape):
    """K10's bfloat16 kind over the whole grid (row 16) == k plain
    bfloat16 steps, bit for bit."""
    st = _bf16_stencil(name)
    fields = tuple(f.to(BF16) for f in _fields(st, shape, dev, 53))
    ref = fused.plain_steps(fields, st, k)
    streamfused.launches.clear()
    got = streamfused.make_stream_fused_step(st, shape, k, device=dev)(fields)
    torch.cuda.synchronize()
    assert dict(streamfused.launches) == {f"stream_step[{name},bfloat16]": 1}
    _check(got, ref, st.halo, 0.0)


@pytest.mark.parametrize("local,origins", [((24, 32, 40), (0, 0)),
                                           ((19, 21, 45), (19, 21))])
@pytest.mark.parametrize("name,k", BF16_STREAM[:-1])
def test_bf16_stream_slab_kernels_match_plain(dev, name, k, local, origins):
    """K10's bfloat16 kind on a z-only shard (row 17) and a shard of a
    mesh that shards y (row 18), on random bfloat16 pieces, bit for bit."""
    st = _bf16_stencil(name)
    m = k * st.halo * (2 if name == "sor3d" else 1)
    Lz, Ly, X = local
    gshape = (3 * Lz, 3 * Ly, X)
    seed = iter(range(500, 600))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)).to(BF16)
                     for _ in range(st.num_fields))

    core = per_field(local)
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    streamfused.launches.clear()
    got = streamfused.stream_zslab(core, zlo, zhi, st, k, gshape[0],
                                   origins[0])
    ref = fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], origins[0])
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    args = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, origins)
    got = streamfused.stream_yzslab(*args)
    ref = fused.plain_yzslab(*args)
    torch.cuda.synchronize()
    _check(got, ref, None, 0.0)
    assert dict(streamfused.launches) == {
        f"stream_zslab[{name},bfloat16]": 1,
        f"stream_yzslab[{name},bfloat16]": 1}


@pytest.mark.parametrize("mesh_shape", [(4,), (2, 2)])
@pytest.mark.parametrize("shape", RING_SHAPES + [(4, 7, 129)])
def test_bf16_ring_exchange_matches_plain(dev, shape, mesh_shape):
    """The ring exchange on bfloat16 slabs (16-byte units where they align,
    2-byte units where not: (3, 5, 130), (4, 7, 129)) == its plain version
    and the ring shift, bit for bit, three launches, counters drained."""
    mesh = make_mesh(mesh_shape, [dev] * 4)
    for axis in (0, 1):
        if mesh.counts(3)[axis] == 1:
            continue
        nxt, prv = _ring(mesh, axis)
        hi = [_pieces(shape, dev, 700 + i).to(BF16) for i in range(4)]
        lo = [_pieces(shape, dev, 750 + i).to(BF16) for i in range(4)]
        call, meta = remote.build_ring_exchange_call(shape, BF16,
                                                     device=dev)
        assert (meta["chunk_axis"], meta["nchunks"]) == remote.pick_chunks(
            shape, 2)
        ref = remote.plain_ring_exchange(
            [h.cpu() for h in hi], [x.cpu() for x in lo], nxt, prv, meta,
            remote.RingState(meta, 4, "cpu"))
        for _ in range(3):
            remote.launches.clear()
            got = call(hi, lo, nxt, prv)
            torch.cuda.synchronize()
            assert dict(remote.launches) == {
                f"ring_exchange[{'x'.join(map(str, shape))},bfloat16]": 1}
            call.state.check_drained(meta)
            for i in range(4):
                assert torch.equal(got[0][i].cpu(), ref[0][i])
                assert torch.equal(got[1][i].cpu(), ref[1][i])


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4,)])
@pytest.mark.parametrize("name", ["wave3d", "grayscott3d"])
def test_bf16_rdma_sharded_step_matches_ppermute(dev, name, mesh_shape):
    """The stream kind's sharded step on bfloat16 fields through the ring
    kernel == the in-process exchange, bit for bit, two calls."""
    st = _bf16_stencil(name)
    shape = (48, 48, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(tuple(f.to(BF16) for f in
                                _fields(st, shape, dev, 57)), mesh, 3)
    outs = []
    for exchange in ("ppermute", "rdma"):
        step = make_sharded_fused_step(st, mesh, shape, 4, kind="stream",
                                       exchange=exchange, device=dev)
        remote.launches.clear()
        f = fields
        for _ in range(2):
            f = step(f)
        outs.append(gather_fields(f))
        torch.cuda.synchronize()
        assert bool(remote.launches) == (exchange == "rdma")
    for a, b in zip(*outs):
        assert a.dtype == BF16 and torch.equal(a, b)


# ---- K3, its shells, K6 and K9 in bfloat16; K6/K9's new families -----------

BF16_FUSED = [("heat3d", 8), ("heat3d27", 8), ("heat3d4th", 4),
              ("wave3d", 8), ("advect3d", 8), ("grayscott3d", 8),
              ("sor3d", 4)]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 128), (18, 22, 45)])
@pytest.mark.parametrize("name,k", BF16_FUSED)
def test_bf16_fused_step_matches_plain(dev, name, k, shape, periodic):
    """K3's bfloat16 kind (row 5) == k plain bfloat16 steps, bit for bit;
    sor3d's periodic wrap over an odd extent is refused, as in the TPU
    package (its colours would disagree across the wrap)."""
    st = _bf16_stencil(name)
    if not fused.parity_consistent(st, shape, periodic):
        assert fused.make_fused_step(st, shape, k, periodic=periodic) is None
        return
    fields = tuple(f.to(BF16) for f in _fields(st, shape, dev, 61))
    ref = fused.plain_steps(fields, st, k, periodic)
    fused.launches.clear()
    got = fused.fused_step(fields, st, k, periodic=periodic)
    torch.cuda.synchronize()
    assert dict(fused.launches) == {f"fused_step[{name},bfloat16]": 1}
    _check(got, ref, None if periodic else st.halo, 0.0)


@pytest.mark.parametrize("dtype,name,k", [(BF16, n, k) for n, k in BF16_FUSED]
                         + [(torch.float32, "advect3d", 4),
                            (torch.float32, "grayscott3d", 4)])
def test_fused_slab_kinds_match_plain(dev, dtype, name, k):
    """K3's sharded mode and its shells (rows 5, 7), K6 and K9 (rows 8, 9)
    on random pieces of a shard, bfloat16 for every family and float32 for
    advect3d and grayscott3d, bit for bit against their plain versions."""
    st = _bf16_stencil(name) if dtype == BF16 else \
        port.make_stencil(name, **({"cx": -0.3, "cz": 0.25}
                                   if name == "advect3d" else {}))
    m = k * st.halo * (2 if name == "sor3d" else 1)
    Lz, Ly, X = local = (24, 32, 40)
    gshape = (3 * Lz, 3 * Ly, X)
    seed = iter(range(700, 800))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)).to(dtype)
                     for _ in range(st.num_fields))

    padded = per_field((Lz + 2 * m, Ly + 2 * m, X))
    _check(fused.fused_step_padded(padded, st, k, gshape, (Lz, 0)),
           fused.plain_step_padded(padded, st, k, gshape, (Lz, 0)), None, 0.0)
    core = per_field(local)
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    _check(fused.fused_zslab(core, zlo, zhi, st, k, gshape[0], Lz),
           fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], Lz), None, 0.0)
    args = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, (Lz, Ly))
    _check(fused.fused_yzslab(*args), fused.plain_yzslab(*args), None, 0.0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_shape,kind", [((2, 2), None),
                                             ((2, 2), "padfree"),
                                             ((4,), "padfree"),
                                             ((2, 2), "stream")])
@pytest.mark.parametrize("name", ["heat3d", "wave3d", "grayscott3d"])
def test_bf16_sharded_fused_steps_match_plain_sharded_steps(
        dev, name, mesh_shape, kind, overlap):
    """The bfloat16 sharded fused steps at k = 8 (K3's sharded mode, K9,
    K6, K10; the shells with --overlap) == 8 plain sharded bfloat16 steps,
    bit for bit."""
    st = _bf16_stencil(name)
    shape = (96, 96, 40)
    mesh = make_mesh(mesh_shape, [dev] * 4)
    fields = shard_fields(tuple(f.to(BF16) for f in
                                _fields(st, shape, dev, 63)), mesh, 3)
    plain = make_sharded_step(st, mesh, shape)
    ref = fields
    for _ in range(8):
        ref = plain(ref)
    step = make_sharded_fused_step(st, mesh, shape, 8, kind=kind,
                                   overlap=overlap, device=dev)
    assert step._overlap_active == overlap
    got = gather_fields(step(fields))
    torch.cuda.synchronize()
    for a, b in zip(got, gather_fields(ref)):
        assert a.dtype == BF16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# bfloat16 on the compute_fn kernels K4, K5, K7 and the 2D k-step kernel K8
# (rows 12-15)
# ---------------------------------------------------------------------------

BF16_2D = [("heat2d", {}), ("wave2d", {}), ("advect2d", {"cx": -0.4,
                                                         "cy": 0.2}),
           ("grayscott2d", {}), ("sor2d", {})]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["heat3d", "heat3d27", "heat3d4th",
                                  "wave3d"])
def test_bf16_compute_fn_kernel_matches_plain(dev, name, shape):
    """K4 (three tap sets) and K5 in bfloat16 on a padded random block ==
    the stencil's plain update on bfloat16 tensors, bit for bit; counted
    as their bfloat16 kind."""
    st = port.make_stencil(name, dtype="bfloat16")
    h = st.halo
    p = _pieces(tuple(s + 2 * h for s in shape), dev, 91).to(BF16)
    ins = (p,) if st.num_fields == 1 else (
        p, _pieces(shape, dev, 92).to(BF16))
    kernels.launches.clear()
    got = kernels.make_pallas_compute(st, device=dev)(ins)
    torch.cuda.synchronize()
    wrapper = "zchunk_wave" if name == "wave3d" else "zchunk_heat"
    assert kernels.launches == {f"{wrapper}[{name},bfloat16]": 1}
    assert got[0].dtype == BF16 and torch.equal(got[0], st.update(ins)[0])


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_bf16_whole2d_kernel_matches_plain(dev, shape):
    """K7 heat2d in bfloat16 == the plain update, bit for bit."""
    st = port.make_stencil("heat2d", dtype="bfloat16")
    p = (_pieces(tuple(s + 2 for s in shape), dev, 93).to(BF16),)
    kernels.launches.clear()
    got = kernels.make_pallas_compute(st, device=dev)(p)[0]
    torch.cuda.synchronize()
    assert kernels.launches == {"whole2d[heat2d,bfloat16]": 1}
    assert got.dtype == BF16 and torch.equal(got, st.update(p)[0])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 20])
@pytest.mark.parametrize("shape", [(128, 256), (130, 258)])
@pytest.mark.parametrize("name,kw", BF16_2D, ids=_ids(BF16_2D))
def test_bf16_fullgrid_kernel_matches_plain(dev, name, kw, shape, k,
                                            periodic):
    """K8 RAW in bfloat16 == k plain bfloat16 steps, bit for bit (k past
    K_PER_LAUNCH micro-steps takes several launches)."""
    st = port.make_stencil(name, dtype="bfloat16", **kw)
    fields = tuple(f.to(BF16) for f in _fields_2d(st, shape, dev, 94))
    plain = driver.make_step(st, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                      device=dev)(fields)
    torch.cuda.synchronize()
    per = fullgrid.K_PER_LAUNCH // (2 if name == "sor2d" else 1)
    assert fullgrid.launches == {
        f"fullgrid_step[{st.name},bfloat16]": -(-k // per)}
    for a, b in zip(got, ref):
        assert a.dtype == BF16 and torch.equal(a, b)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name,kw", BF16_2D, ids=_ids(BF16_2D))
def test_bf16_sharded_fullgrid_kernel_matches_plain_sharded_steps(
        dev, name, kw, periodic, overlap):
    """K8 PADDED in bfloat16 (and its overlap shells) at k = 16 (sor2d 8:
    m = 16, JAX's bfloat16 alignment) on a 4-row-shard split == k plain
    sharded bfloat16 steps, bit for bit."""
    st = port.make_stencil(name, dtype="bfloat16", **kw)
    k = 8 if name == "sor2d" else 16
    shape = (256, 200)
    mesh = make_mesh((4,), [dev] * 4)
    fields = shard_fields(tuple(f.to(BF16) for f in
                                _fields_2d(st, shape, dev, 95)), mesh, 2)
    plain = make_sharded_step(st, mesh, shape, periodic=periodic)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    fullgrid.launches.clear()
    step = make_sharded_temporal_step(st, mesh, shape, k, periodic=periodic,
                                      overlap=overlap, device=dev)
    got = step(fields)
    torch.cuda.synchronize()
    assert step._overlap_active == overlap
    assert fullgrid.launches == {
        f"fullgrid_padded[{name},bfloat16]": 4 * (3 if overlap else 1)}
    for a, b in zip(gather_fields(got), gather_fields(ref)):
        assert a.dtype == BF16 and torch.equal(a, b)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", ["heat3d", "wave3d", "heat3d4th"])
def test_bf16_sharded_compute_fn_step_matches_plain_sharded_step(
        dev, name, overlap):
    """make_sharded_step with the bfloat16 K4/K5 compute_fn (± the overlap
    split) on a 2x2 mesh == the plain sharded bfloat16 step, bit for bit;
    periodic with K4 equals the plain periodic step."""
    st = port.make_stencil(name, dtype="bfloat16")
    shape = (48, 40, 36)
    mesh = make_mesh((2, 2), [dev] * 4)
    fields = shard_fields(tuple(f.to(BF16) for f in
                                _fields(st, shape, dev, 96)), mesh, 3)
    comp = kernels.make_pallas_compute(st, device=dev)
    for periodic in (False, True):
        ref = make_sharded_step(st, mesh, shape, periodic=periodic)(fields)
        step = make_sharded_step(st, mesh, shape, periodic=periodic,
                                 compute_fn=comp, overlap=overlap)
        kernels.launches.clear()
        got = step(fields)
        torch.cuda.synchronize()
        assert sum(kernels.launches.values()) >= 4
        for a, b in zip(gather_fields(got), gather_fields(ref)):
            assert a.dtype == BF16 and torch.equal(a, b)


def test_bf16_2d_and_compute_fn_wrappers_refuse_other_types(dev):
    """K4, K5, K7 and K8 take float32 and bfloat16 (Life int32): float16
    raises, as does a bfloat16 Life and a type mix."""
    h = torch.rand(10, 10, 34, device=dev).to(torch.float16)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        kernels.zchunk_heat(h, port.make_stencil("heat3d"))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        kernels.whole2d(h[0].contiguous(), port.make_stencil("heat2d"))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fullgrid.fullgrid_step((h[0].contiguous(),),
                               port.make_stencil("heat2d"), 4)
    with pytest.raises(TypeError, match="int32"):
        fullgrid.fullgrid_step((h[0].to(BF16).contiguous(),),
                               port.make_stencil("life"), 4)
    u = torch.rand(8, 8, 32, device=dev)
    with pytest.raises(TypeError, match="operands of one type"):
        kernels.zchunk_wave(torch.rand(10, 10, 34, device=dev), u.to(BF16),
                            port.make_stencil("wave3d"))


# ---- the redesigned ring exchange and fused_step: every site and path ------

# The ring's sites on the main path: heat3d 1024^3 on 2x2 (z slab, y slab,
# corner), on --mesh 4 (z slab), and config 5's z slab (bfloat16 only).
RING_SITES = [((2, 2), 0, (4, 512, 1024)), ((2, 2), 1, (512, 4, 1024)),
              ((2, 2), 1, (4, 4, 1024)), ((4,), 0, (4, 1024, 1024))]


@pytest.mark.parametrize(
    "mesh_shape,axis,shape,dtype",
    [s + (dt,) for s in RING_SITES for dt in (torch.float32, BF16)]
    + [((4,), 0, (4, 4096, 4096), BF16)])
def test_ring_exchange_sites_match_copy_and_plain(dev, mesh_shape, axis,
                                                  shape, dtype):
    """The ring at the main path's sites == one copy_ per slab and its
    plain version, bit for bit, three launches, every chunk's ready counter
    drained (the blocks that wrote it) after each."""
    mesh = make_mesh(mesh_shape, [dev] * 4)
    nxt, prv = _ring(mesh, axis)
    hi = [_pieces(shape, dev, 1300 + i).to(dtype) for i in range(4)]
    lo = [_pieces(shape, dev, 1350 + i).to(dtype) for i in range(4)]
    call, meta = remote.build_ring_exchange_call(shape, dtype, device=dev)
    copies = ([torch.empty_like(h) for h in hi],
              [torch.empty_like(x) for x in lo])
    for i in range(4):
        copies[0][i].copy_(hi[prv[i]])
        copies[1][i].copy_(lo[nxt[i]])
    plain = remote.plain_ring_exchange(hi, lo, nxt, prv, meta,
                                       remote.RingState(meta, 4, dev))
    for _ in range(3):
        got = call(hi, lo, nxt, prv)
        torch.cuda.synchronize()
        call.state.check_drained(meta)
        assert call.state.blocks >= 1
        for d in (0, 1):
            for i in range(4):
                assert torch.equal(got[d][i], copies[d][i])
                assert torch.equal(got[d][i], plain[d][i])


# (name, float32 k, bfloat16 k) of every fused family
FUSED_KS = [("heat3d", 4, 8), ("heat3d27", 4, 8), ("heat3d4th", 2, 4),
            ("wave3d", 4, 8), ("sor3d", 2, 4), ("advect3d", 4, 8),
            ("grayscott3d", 4, 8)]
# (48, 48, 128): interior blocks (16-byte row copies, no frame test) beside
# wall and x-edge ones; (46, 50, 136): ragged z, y and x extents on aligned
# rows; (40, 36, 130): rows off the 16-byte unit (the per-cell load
# everywhere)
PATH_SHAPES = [(48, 48, 128), (46, 50, 136), (40, 36, 130)]
# launch tiles beside the table's: deeper, wider (512 threads), and one
# whose columns outnumber the threads unevenly
ALT_TILES = [(16, 8, 32, 256), (8, 16, 32, 512), (8, 8, 64, 128)]


def _fused_stencil(name, dtype):
    kw = {"cx": -0.3, "cy": 0.2, "cz": 0.25} if name == "advect3d" else {}
    return port.make_stencil(name, dtype=dtype, **kw)


def _all_paths(fn, monkeypatch, st, k):
    """fn() under the table's tile, every fast path off, and each of
    ALT_TILES."""
    outs = [fn()]
    with monkeypatch.context() as mp:
        mp.setattr(fused, "PATHS", 0)
        outs.append(fn())
    for tile in ALT_TILES:
        with monkeypatch.context() as mp:
            mp.setitem(fused.TILES, (st.name, str(st.dtype).replace(
                "torch.", ""), k), tile)
            outs.append(fn())
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", PATH_SHAPES)
@pytest.mark.parametrize("name,k32,k16", FUSED_KS)
def test_fused_step_block_paths_match_plain(dev, monkeypatch, name, k32,
                                            k16, shape, periodic, dtype):
    """K3 (RAW) == k plain steps, bit for bit, for every family in float32
    and bfloat16: interior blocks on the fast paths, walls, periodic wraps,
    x edges and ragged extents on the per-cell path, under the table's
    tile, with the fast paths off and under other tiles."""
    st = _fused_stencil(name, dtype)
    k = k32 if dtype == torch.float32 else k16
    if not fused.parity_consistent(st, shape, periodic):
        assert fused.make_fused_step(st, shape, k, periodic=periodic) is None
        return
    fields = tuple(f.to(dtype) for f in _fields(st, shape, dev, 1401))
    ref = fused.plain_steps(fields, st, k, periodic)
    for got in _all_paths(
            lambda: fused.fused_step(fields, st, k, periodic=periodic),
            monkeypatch, st, k):
        torch.cuda.synchronize()
        _check(got, ref, None if periodic else st.halo, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("origins", [(0, 0), (48, 48), (96, 48)])
@pytest.mark.parametrize("name,k32,k16", FUSED_KS)
def test_fused_sharded_block_paths_match_plain(dev, monkeypatch, name, k32,
                                               k16, origins, periodic,
                                               dtype):
    """K3's sharded mode (PADDED), a shell (a 2m-deep core), K6 (ZSLAB)
    and K9 (YZSLAB) on a (48, 48, 128) shard of a (144, 144, 128) grid at
    a wall corner, in the middle (z and y seams on every side) and on a
    z wall, guard-frame and periodic, == their plain versions bit for bit,
    in float32 and bfloat16, on every path and tile."""
    st = _fused_stencil(name, dtype)
    k = k32 if dtype == torch.float32 else k16
    m = fused.k_step_margin(st, k)
    Lz, Ly, X = 48, 48, 128
    gshape = (3 * Lz, 3 * Ly, X)
    oz, oy = origins
    seed = iter(range(1500, 1700))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)).to(dtype)
                     for _ in range(st.num_fields))

    padded = per_field((Lz + 2 * m, Ly + 2 * m, X))
    strip = per_field((4 * m, Ly + 2 * m, X))
    core = per_field((Lz, Ly, X))
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    yz = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, origins)
    cases = [
        (lambda: fused.fused_step_padded(padded, st, k, gshape, origins,
                                         periodic),
         fused.plain_step_padded(padded, st, k, gshape, origins, periodic)),
        (lambda: fused.fused_step_padded(strip, st, k, gshape,
                                         (oz + Lz - 2 * m, oy), periodic),
         fused.plain_step_padded(strip, st, k, gshape,
                                 (oz + Lz - 2 * m, oy), periodic)),
        (lambda: fused.fused_zslab(core, zlo, zhi, st, k, gshape[0], oz,
                                   periodic),
         fused.plain_zslab(core, zlo, zhi, st, k, gshape[0], oz, periodic)),
        (lambda: fused.fused_yzslab(*yz, periodic=periodic),
         fused.plain_yzslab(*yz, periodic=periodic))]
    for fn, ref in cases:
        for got in _all_paths(fn, monkeypatch, st, k):
            torch.cuda.synchronize()
            _check(got, ref, None, 0.0)


# ---------------------------------------------------------------------------
# K10 and K8's streaming kind (csrc/ring.cuh): every family on the fast
# paths (16-byte row copies, no y/x frame test), on the per-cell path
# (PATHS = 0) and under two other tiles, bit-equal to the plain version

# (name, float32 k, bfloat16 k) of every K10 family: the keys of
# streamfused.TILES
STREAM_KS = [("heat3d", 4, 4), ("heat3d27", 4, 4), ("heat3d4th", 2, 4),
             ("wave3d", 4, 4), ("sor3d", 2, 4), ("advect3d", 4, 4),
             ("grayscott3d", 4, 4)]
# (40, 56, 256): interior columns (x inside the grid past the widened
# margin) beside wall ones; (38, 50, 264): ragged extents on aligned rows;
# (40, 36, 258): rows off the 16-byte unit (the per-cell load everywhere)
STREAM_SHAPES = [(40, 56, 256), (38, 50, 264), (40, 36, 258)]
# columns beside the table's: narrower (more interior blocks; two blocks
# an SM), and one whose levels get few warps each
STREAM_ALT_TILES = [(8, 32, 512, 2), (16, 32, 384, 1)]


def _stream_paths(fn, monkeypatch, st, k):
    """fn() under the table's tile, every fast path off, and each of
    STREAM_ALT_TILES."""
    outs = [fn()]
    with monkeypatch.context() as mp:
        mp.setattr(streamfused, "PATHS", 0)
        outs.append(fn())
    key = (st.name, str(st.dtype).replace("torch.", ""), k)
    for tile in STREAM_ALT_TILES:
        with monkeypatch.context() as mp:
            mp.setitem(streamfused.TILES, key, tile)
            assert streamfused.tile_of(st, k) == tile
            outs.append(fn())
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape", STREAM_SHAPES)
@pytest.mark.parametrize("name,k32,k16", STREAM_KS)
def test_stream_step_block_paths_match_plain(dev, monkeypatch, name, k32,
                                             k16, shape, dtype):
    """K10 (RAW) == k plain steps, bit for bit, for every family in float32
    and bfloat16: interior columns on the fast paths, walls, x edges and
    ragged extents on the per-cell path, under the table's tile, with the
    fast paths off and under other tiles."""
    st = _fused_stencil(name, dtype)
    k = k32 if dtype == torch.float32 else k16
    fields = tuple(f.to(dtype) for f in _fields(st, shape, dev, 1411))
    ref = fused.plain_steps(fields, st, k)
    streamfused.launches.clear()
    for got in _stream_paths(lambda: streamfused.stream_step(fields, st, k),
                             monkeypatch, st, k):
        torch.cuda.synchronize()
        _check(got, ref, st.halo, 0.0)
    assert sum(streamfused.launches.values()) == 2 + len(STREAM_ALT_TILES)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("origins", [(0, 0), (48, 48), (96, 48)])
@pytest.mark.parametrize("name,k32,k16", STREAM_KS)
def test_stream_sharded_block_paths_match_plain(dev, monkeypatch, name, k32,
                                                k16, origins, dtype):
    """K10's ZSLAB and YZSLAB kinds on a (48, 48, 256) shard of a
    (144, 144, 256) grid at a wall corner, in the middle and on a z wall
    == their plain versions bit for bit, in float32 and bfloat16, on
    every path and tile."""
    st = _fused_stencil(name, dtype)
    k = k32 if dtype == torch.float32 else k16
    m = fused.k_step_margin(st, k)
    Lz, Ly, X = 48, 48, 256
    gshape = (3 * Lz, 3 * Ly, X)
    seed = iter(range(1700, 1900))

    def per_field(shape):
        return tuple(_pieces(shape, dev, next(seed)).to(dtype)
                     for _ in range(st.num_fields))

    core = per_field((Lz, Ly, X))
    zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
    ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
    corners = [per_field((m, m, X)) for _ in range(4)]
    yz = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, origins)
    zs = (core, zlo, zhi, st, k, gshape[0], origins[0])
    cases = [(lambda: streamfused.stream_zslab(*zs), fused.plain_zslab(*zs)),
             (lambda: streamfused.stream_yzslab(*yz),
              fused.plain_yzslab(*yz))]
    for fn, ref in cases:
        for got in _stream_paths(fn, monkeypatch, st, k):
            torch.cuda.synchronize()
            _check(got, ref, None, 0.0)


# (name, stencil kwargs, float32/int32 k, bfloat16 k or None) of every K8
# family at the main path's k (sor2d's margin is 2k)
FULLGRID_KS = [("heat2d", {}, 8, 16), ("life", {}, 8, None),
               ("wave2d", {}, 8, 16), ("advect2d", {"cx": -0.4, "cy": 0.3},
                                       8, 16),
               ("grayscott2d", {}, 8, 16), ("sor2d", {}, 8, 8)]
# (100, 1600): interior strips beside wall ones; (77, 1544): ragged rows
# and strips; (60, 1030): rows off the 16-byte unit
RING_SHAPES_2D = [(100, 1600), (77, 1544), (60, 1030)]
# strips beside the table's: narrow with short chunks (many chunk
# lead-ins), and a wide one with a ragged chunk
RING_ALT_TILES = [(128, 24, 768, 1), (512, 70, 512, 2)]


def _ring_paths(fn, monkeypatch, st, k):
    """fn() under the table's tile, every fast path off, and each of
    RING_ALT_TILES."""
    outs = [fn()]
    with monkeypatch.context() as mp:
        mp.setattr(fullgrid, "PATHS", 0)
        outs.append(fn())
    key = (st.name, str(st.dtype).replace("torch.", ""), k)
    for tile in RING_ALT_TILES:
        with monkeypatch.context() as mp:
            mp.setitem(fullgrid.RING_TILES, key, tile)
            assert fullgrid.ring_tile(st, k) == tile
            outs.append(fn())
    return outs


@pytest.mark.parametrize("mode", ["raw", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape", RING_SHAPES_2D)
@pytest.mark.parametrize("name,kw,k32,k16", FULLGRID_KS)
def test_fullgrid_stream_kind_block_paths_match_plain(
        dev, monkeypatch, name, kw, k32, k16, shape, dtype, mode):
    """K8's streaming kind == k plain steps bit for bit, on the whole grid
    (RAW) and on a row shard's padded block at global rows shape[0]..
    of 3 shape[0] (PADDED), for every family in float32 (Life int32) and
    bfloat16, on the fast paths, the per-cell path and other tiles."""
    if name == "life":  # int32, its one type
        dtype = torch.int32
    st = port.make_stencil(name, dtype=dtype, **kw)
    k = k16 if dtype == BF16 else k32
    H, W = shape
    m = fused.k_step_margin(st, k)
    rows = H if mode == "raw" else H + 2 * m
    fields = tuple(f.to(dtype) for f in _fields_2d(st, (rows, W), dev, 1901))
    monkeypatch.setattr(fullgrid, "RING_MIN_LEADS", 0)  # short grids stream
    assert fullgrid.ring_ok(st, k, False, H)
    fullgrid.launches.clear()
    if mode == "raw":
        ref = fields
        plain = driver.make_step(st, shape)
        for _ in range(k):
            ref = plain(ref)
        fn = lambda: fullgrid.fullgrid_step(fields, st, k)  # noqa: E731
    else:
        out = fused._plain_window_steps(fields, st, k, (H - m, 0),
                                        (3 * H, W), False, wrap_axes=(1,))
        ref = tuple(f[m:m + H] for f in out)
        fn = lambda: fullgrid.fullgrid_padded(  # noqa: E731
            fields, st, k, 3 * H, H)
    for got in _ring_paths(fn, monkeypatch, st, k):
        torch.cuda.synchronize()
        _check(got, ref, st.halo if mode == "raw" else None, 0.0)
    assert sum(fullgrid.launches.values()) == 2 + len(RING_ALT_TILES)


# ---- K4 and K7, redesigned (csrc/march.cuh) ----------------------------------

TILED_KINDS = [("heat3d", "float32"), ("heat3d", "bfloat16"),
               ("heat3d27", "float32"), ("heat3d27", "bfloat16"),
               ("heat3d4th", "float32"), ("heat3d4th", "bfloat16"),
               ("heat2d", "float32"), ("heat2d", "bfloat16"),
               ("life", "int32")]
# x extents in each residue mod 8; one plane, one row, one cell; a run that
# does not divide the march extent
TILED_SHAPES_3D = [(5, 6, 64 + r) for r in range(8)] + [
    (1, 9, 37), (7, 1, 130), (9, 5, 1), (3, 2, 7), (67, 3, 33)]
TILED_SHAPES_2D = [(7, 512 + r) for r in range(8)] + [
    (1, 1000), (600, 1), (5, 3), (515, 129)]


@pytest.mark.parametrize("name,dtype", TILED_KINDS,
                         ids=[f"{n}-{d}" for n, d in TILED_KINDS])
def test_tiled_compute_kernels_match_plain_at_every_residue(dev, name,
                                                            dtype):
    """K4 and K7 at their table tile (bfloat16: cells in pairs) == the
    plain update, bit for bit, at every x residue mod 8, on one-plane,
    one-row and one-cell blocks and with a run that does not divide the
    march extent; in bfloat16 also on subnormals, signed zeros and ties.
    One launch counted a call, under the kind's usual key."""
    st = port.make_stencil(name) if dtype == "int32" else \
        port.make_stencil(name, dtype=dtype)
    wrapper = "whole2d" if st.ndim == 2 else "zchunk_heat"
    count = f"{wrapper}[{name}]" if dtype in ("float32", "int32") else \
        f"{wrapper}[{name},{dtype}]"
    shapes = TILED_SHAPES_2D if st.ndim == 2 else TILED_SHAPES_3D
    kernels.launches.clear()
    calls = 0
    for i, shape in enumerate(shapes):
        padded = tuple(s + 2 * st.halo for s in shape)
        blocks = [_fields_2d(st, padded, dev, 1500 + i)[0].to(st.dtype)]
        if dtype == "bfloat16":
            g = torch.Generator(device=dev)
            g.manual_seed(1600 + i)
            blocks.append(compute_schedule.special_bf16(padded, g, dev))
        for p in blocks:
            got = kernels.make_pallas_compute(st, device=dev)((p,))[0]
            torch.cuda.synchronize()
            calls += 1
            ref = st.update((p,))[0]
            assert got.dtype == ref.dtype and got.shape == ref.shape
            view = torch.int16 if dtype == "bfloat16" else torch.int32
            assert torch.equal(got.view(view), ref.view(view)), shape
    assert kernels.launches == {count: calls}


@pytest.mark.parametrize("name,dtype", TILED_KINDS,
                         ids=[f"{n}-{d}" for n, d in TILED_KINDS])
def test_tiled_compute_kernels_refuse_a_short_ring(dev, name, dtype):
    """A launch whose ring is one slot short, or whose row buffer is too
    small for its segment, is refused by the kernel (no fallback)."""
    st = port.make_stencil(name) if dtype == "int32" else \
        port.make_stencil(name, dtype=dtype)
    tile = kernels.TILES[(name, dtype)]
    geo = kernels.march_geometry(st, tile)
    p = _fields_2d(st, tuple(8 + 2 * st.halo for _ in range(st.ndim)), dev,
                   1700)[0].to(st.dtype)
    shape = tuple(int(s) - 2 * st.halo for s in p.shape)
    out = torch.empty(shape, dtype=p.dtype, device=dev)
    args = list(kernels._tile_args(st, tile, shape, dev))
    for i, short in ((-1, geo.slots - 1), (-2, geo.row_bytes - 16)):
        bad = list(args)
        bad[i] = short
        if st.ndim == 2:
            lib = kernels._lib2d()
            fn = kernels._build.twin_entry(lib, "whole2d_step", p)
            rc = fn(kernels._WHOLE2D_KIND[name][0], p.data_ptr(),
                    out.data_ptr(), *shape,
                    float(st.params.get("alpha", 0.0)), *bad, 1,
                    kernels._build.stream_of(p))
        else:
            lib = kernels._lib()
            fn = kernels._build.entry(lib, "zchunk_heat", p)
            rc = fn(kernels._HEAT_KIND[name], p.data_ptr(), out.data_ptr(),
                    *shape, *kernels.coefficients(st), *bad, 1,
                    kernels._build.stream_of(p))
        assert rc != 0


# ---- K5, K1, K2 and Gray-Scott, redesigned (csrc/march.cuh) ------------------

MARCH_NEW = [("K5", "wave3d", {}), ("K1", "heat3d", {}),
             ("K1", "heat3d27", {}), ("K1", "heat3d4th", {}),
             ("K1", "advect3d", {"cx": -0.3, "cy": 0.2, "cz": -0.25}),
             ("K2", "wave3d", {}), ("GS", "grayscott3d", {})]
# the raw kinds and their wrappers
RAW_WRAPPER = {"K1": "raw_step_heat", "K2": "raw_step_wave",
               "GS": "raw_step_grayscott"}
MARCH_NEW_CASES = [(k, n, kw, d) for k, n, kw in MARCH_NEW
                   for d in ("float32", "bfloat16")]


def _march_new_shapes(kern, h):
    """K5: TILED_SHAPES_3D; the raw kinds: x in each residue mod 8, the
    smallest grid they take, every tile at a wall, grids with interior
    tiles."""
    if kern == "K5":
        return TILED_SHAPES_3D
    m = 2 * h + 1
    return [(m + 4, m + 5, 64 + r) for r in range(8)] + [
        (m, m, m), (m, 9, 37), (9, m, 130), (67, m + 2, 33),
        (40, 40, 600), (70, 37, 1100)]


@pytest.mark.parametrize("kern,name,kw,dtype", MARCH_NEW_CASES,
                         ids=[f"{k}-{n}-{d}" for k, n, _, d in
                              MARCH_NEW_CASES])
def test_tiled_k5_and_k1_match_plain_at_every_residue(dev, kern, name, kw,
                                                      dtype):
    """K5 (u_prev as a second operand) and the raw kinds K1, K2 and
    Gray-Scott (the raw grid, its frame pinned in the kernel; K2's u_prev
    in registers, Gray-Scott's v on a second ring) at their table tile ==
    the plain update / step, bit for bit, every field, frame cells
    included, on the shapes above; in bfloat16 also on subnormals, signed
    zeros and ties.  One launch a call."""
    st = port.make_stencil(name, dtype=dtype, **kw)
    h = st.halo
    raw = kern != "K5"
    mod = rawstep if raw else kernels
    wrapper = RAW_WRAPPER[kern] if raw else "zchunk_wave"
    count = f"{wrapper}[{name}]" if dtype == "float32" else \
        f"{wrapper}[{name},{dtype}]"
    mod.launches.clear()
    calls = 0
    for i, shape in enumerate(_march_new_shapes(kern, h)):
        first = shape if raw else tuple(s + 2 * h for s in shape)
        shapes = (first,) + (shape,) * (st.num_fields - 1)
        g = torch.Generator(device=dev)
        g.manual_seed(1800 + i)
        blocks = [tuple(torch.rand(s, generator=g, device=dev).to(st.dtype)
                        for s in shapes)]
        if dtype == "bfloat16":
            blocks.append(tuple(compute_schedule.special_bf16(s, g, dev)
                                for s in shapes))
        for ins in blocks:
            if raw:
                got = rawstep.make_raw_step(st, shape, device=dev)(ins)
                ref = driver.make_step(st, shape)(ins)
            else:
                got = kernels.make_pallas_compute(st, device=dev)(ins)[:1]
                ref = st.update(ins)[:1]
            torch.cuda.synchronize()
            calls += 1
            view = torch.int16 if dtype == "bfloat16" else torch.int32
            assert len(got) == len(ref)
            for gf, rf in zip(got, ref):
                assert gf.dtype == rf.dtype
                assert torch.equal(gf.view(view), rf.view(view)), shape
    assert mod.launches == {count: calls}


@pytest.mark.parametrize("kern,name,kw,dtype", MARCH_NEW_CASES,
                         ids=[f"{k}-{n}-{d}" for k, n, _, d in
                              MARCH_NEW_CASES])
def test_tiled_k5_and_k1_refuse_a_short_ring(dev, kern, name, kw, dtype):
    """A K5 or raw-kind launch whose ring is one slot short, or whose row
    buffer is too small, is refused (no fallback); so is K5 or K2 on a
    tile of more than one row a group, and Gray-Scott on rings that
    together exceed one block's shared memory."""
    st = port.make_stencil(name, dtype=dtype, **kw)
    h = st.halo
    shape = (9, 9, 40)
    first = shape if kern != "K5" else tuple(s + 2 * h for s in shape)
    p = torch.rand(first, device=dev).to(st.dtype)
    out = torch.empty(shape, dtype=st.dtype, device=dev)
    tile = (kernels.TILES if kern == "K5" else rawstep.TILES)[(name, dtype)]
    geo = kernels.march_geometry(st, tile)
    args = list(kernels._tile_args(st, tile, shape, dev))
    shorts = [(len(args) - 1, geo.slots - 1),
              (len(args) - 2, geo.row_bytes - 16)]
    up = torch.rand(shape, device=dev).to(st.dtype)
    members = ()  # K5's export takes the member count (one) last
    if kern == "K5":
        members = (1,)
        lib = kernels._lib()
        fn = kernels._build.entry(lib, "zchunk_wave", p)
        head = (p.data_ptr(), up.data_ptr(), out.data_ptr(), *shape,
                kernels.coefficients(st)[0])
    else:
        lib = rawstep._lib()
        fn = kernels._build.entry(lib, RAW_WRAPPER[kern], p)
        if kern == "K1":
            head = (rawstep._HEAT_KIND[name], p.data_ptr(), out.data_ptr(),
                    *shape, *rawstep.coefficients(st))
        elif kern == "K2":
            head = (p.data_ptr(), up.data_ptr(), out.data_ptr(), *shape,
                    rawstep.coefficients(st)[0])
        else:
            ov = torch.empty_like(out)
            head = (p.data_ptr(), up.data_ptr(), out.data_ptr(),
                    ov.data_ptr(), *shape, *rawstep.coefficients(st)[:4])
    assert fn(*head, *args, *members, kernels._build.stream_of(p)) == 0
    if kern in ("K5", "K2"):  # not a z-queue tile
        shorts.append((1, 0))
    if kern == "GS":  # two rings past one block's shared memory
        per_row = kernels._build.SMEM_LIMIT // (2 * geo.slots * geo.rows)
        shorts.append((len(args) - 2, per_row // 16 * 16 + 16))
    for i, short in shorts:
        bad = list(args)
        bad[i] = short
        assert fn(*head, *bad, *members, kernels._build.stream_of(p)) != 0


# ---- the member axis: N members of an ensemble in one launch ----------------
#
# Every kernel of the ensemble path takes a batched block (a leading member
# axis): K4, K5 and K7 put the members among the items of their persistent
# grid, K8's tiled kind in its launch grid's z, K8's streaming kind, K10 and
# K3/K6/K9 fold them into z.  Each batched launch is held bit for bit to
# the unbatched launches of its members (the same arithmetic a member) and
# to the plain version on the batch (K3/K6/K9 float32 within their atol:
# they reassociate taps), and counts one launch under its ",ensemble" key.
# N = 3, so a member stride that is off shows.

ENS_N = 3
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
         torch.int32: torch.int32}


def _members(st, shape, dev, seed, n=ENS_N):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if st.dtype == torch.int32:
        return tuple((torch.rand((n,) + tuple(shape), generator=g,
                                 device=dev) < 0.3).to(torch.int32)
                     for _ in range(st.num_fields))
    return tuple(torch.rand((n,) + tuple(shape), generator=g,
                            device=dev).to(st.dtype)
                 for _ in range(st.num_fields))


def _same_bits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, (g.shape, r.shape)
        assert torch.equal(g.view(_BITS[g.dtype]), r.view(_BITS[r.dtype]))


def _close(got, ref, atol):
    if atol == 0.0:
        _same_bits(got, ref)
        return
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g.float() - r.float()).abs().max()) <= atol


def _per_member(fn, *batched):
    """``fn`` on each member's operands (tuples of batched tensors, or
    lists of such tuples), stacked back on the member axis."""
    def pick(x, i):
        if isinstance(x, torch.Tensor):
            return x[i].contiguous()
        return type(x)(pick(y, i) for y in x)

    outs = [fn(*(pick(b, i) for b in batched)) for i in range(ENS_N)]
    return tuple(torch.stack([o[j] for o in outs])
                 for j in range(len(outs[0])))


def _one_launch(counter, key):
    assert dict(counter) == {key: 1}, dict(counter)


def _ens_key(wrapper, st):
    dt = "" if st.dtype in (torch.float32, torch.int32) else \
        "," + str(st.dtype).replace("torch.", "")
    return f"{wrapper}[{st.name}{dt},ensemble]"


ENS_COMPUTE = [(n, d) for n, d in kernels.TILES]


@pytest.mark.parametrize("name,dtype", ENS_COMPUTE,
                         ids=[f"{n}-{d}" for n, d in ENS_COMPUTE])
def test_ensemble_compute_fn_kernels_one_launch(dev, name, dtype):
    """K4, K5 and K7 on a batch of three padded blocks: one launch, each
    member bit-equal to its own launch and to the plain update."""
    st = port.make_stencil(name, dtype=dtype)
    h = st.halo
    shape = (37, 300) if st.ndim == 2 else (17, 19, 45)
    padded = tuple(s + 2 * h for s in shape)
    ins = _members(st, padded, dev, 2200)
    if name == "wave3d":
        ins = (ins[0], _members(st, shape, dev, 2201)[0])
    comp = kernels.make_pallas_compute(st, device=dev)
    kernels.launches.clear()
    got = comp(ins)[:1]
    torch.cuda.synchronize()
    wrapper = {2: "whole2d", 3: "zchunk_wave" if name == "wave3d"
               else "zchunk_heat"}[st.ndim]
    _one_launch(kernels.launches, _ens_key(wrapper, st))
    _same_bits(got, st.update(ins)[:1])
    _same_bits(got, _per_member(lambda *f: comp(f)[:1], *ins))


ENS_K8 = [("heat2d", "float32", 8, False), ("heat2d", "float32", 4, True),
          ("heat2d", "bfloat16", 16, False), ("life", "int32", 8, False),
          ("life", "int32", 8, True), ("wave2d", "float32", 8, False),
          ("grayscott2d", "float32", 8, False), ("sor2d", "float32", 8, False),
          ("advect2d", "float32", 4, True)]


@pytest.mark.parametrize("name,dtype,k,periodic", ENS_K8,
                         ids=[f"{n}-{d}-k{k}-{'p' if p else 'g'}"
                              for n, d, k, p in ENS_K8])
def test_ensemble_fullgrid_both_kinds_one_launch(dev, name, dtype, k,
                                                 periodic):
    """K8 on three members: the streaming kind (guard frame) and the tiled
    kind (periodic), whole grid and one row shard's padded block."""
    st = port.make_stencil(name, dtype=dtype)
    shape = (200, 130)
    fields = _members(st, shape, dev, 2300)
    fullgrid.launches.clear()
    got = fullgrid.fullgrid_step(fields, st, k, periodic)
    torch.cuda.synchronize()
    launches = -(-k // fullgrid._steps_per_launch(st))
    assert dict(fullgrid.launches) == {
        _ens_key("fullgrid_step", st): launches}
    cpu = tuple(f.cpu() for f in fields)
    _same_bits(tuple(g.cpu() for g in got),
               fullgrid.fullgrid_step(cpu, st, k, periodic))
    _same_bits(got, _per_member(
        lambda *f: fullgrid.fullgrid_step(f, st, k, periodic), *fields))
    m = fused.k_step_margin(st, k)
    padded = _members(st, (64 + 2 * m, 130), dev, 2301)
    fullgrid.launches.clear()
    got = fullgrid.fullgrid_padded(padded, st, k, 256, 64, periodic)
    torch.cuda.synchronize()
    _one_launch(fullgrid.launches, _ens_key("fullgrid_padded", st))
    _same_bits(tuple(g.cpu() for g in got), fullgrid.fullgrid_padded(
        tuple(p.cpu() for p in padded), st, k, 256, 64, periodic))
    _same_bits(got, _per_member(
        lambda *p: fullgrid.fullgrid_padded(p, st, k, 256, 64, periodic),
        *padded))


ENS_3D = [("heat3d", "float32", 4), ("wave3d", "float32", 4),
          ("grayscott3d", "float32", 4), ("sor3d", "float32", 4),
          ("heat3d4th", "float32", 2), ("heat3d", "bfloat16", 8)]


def _window_atol(st):
    """K3/K6/K9's tolerance against the plain version: float32 heat and
    wave kinds reassociate taps; bfloat16, SOR, advection and
    Gray-Scott's kinds are bit-equal."""
    return 1e-4 if st.dtype == torch.float32 and st.name in (
        "heat3d", "heat3d27", "heat3d4th", "wave3d") else 0.0


@pytest.mark.parametrize("name,dtype,k", ENS_3D,
                         ids=[f"{n}-{d}-k{k}" for n, d, k in ENS_3D])
def test_ensemble_stream_kernel_three_modes_one_launch(dev, name, dtype, k):
    """K10 on three members: the whole grid, a z-only shard's slabs and a
    (z, y) shard's slab set, each in one launch."""
    st = port.make_stencil(name, dtype=dtype)
    m = fused.k_step_margin(st, k)
    shape = (40, 36, 70)
    fields = _members(st, shape, dev, 2400)
    streamfused.launches.clear()
    got = streamfused.stream_step(fields, st, k)
    torch.cuda.synchronize()
    _one_launch(streamfused.launches, _ens_key("stream_step", st))
    _same_bits(got, fused.plain_steps(fields, st, k))
    _same_bits(got, _per_member(
        lambda *f: streamfused.stream_step(f, st, k), *fields))
    core, lo, hi = (_members(st, s, dev, 2401 + i) for i, s in
                    enumerate((shape, (m,) + shape[1:], (m,) + shape[1:])))
    streamfused.launches.clear()
    got = streamfused.stream_zslab(core, lo, hi, st, k, 120, 40)
    torch.cuda.synchronize()
    _one_launch(streamfused.launches, _ens_key("stream_zslab", st))
    _same_bits(got, fused.plain_zslab(core, lo, hi, st, k, 120, 40))
    _same_bits(got, _per_member(
        lambda c, a, b: streamfused.stream_zslab(c, a, b, st, k, 120, 40),
        core, lo, hi))
    Lz, Ly, X = shape
    pieces = [_members(st, s, dev, 2410 + i) for i, s in enumerate(
        ((m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X))
        + ((m, m, X),) * 4)]
    args = (core, *pieces[:4], pieces[4:])
    gshape, org = (3 * Lz, 2 * Ly, X), (Lz, Ly)
    streamfused.launches.clear()
    got = streamfused.stream_yzslab(*args, st, k, gshape, org)
    torch.cuda.synchronize()
    _one_launch(streamfused.launches, _ens_key("stream_yzslab", st))
    _same_bits(got, fused.plain_yzslab(*args, st, k, gshape, org))
    _same_bits(got, _per_member(
        lambda c, zl, zh, yl, yh, cs: streamfused.stream_yzslab(
            c, zl, zh, yl, yh, cs, st, k, gshape, org), *args))


@pytest.mark.parametrize("name,dtype,k", ENS_3D,
                         ids=[f"{n}-{d}-k{k}" for n, d, k in ENS_3D])
def test_ensemble_window_kernels_one_launch(dev, name, dtype, k):
    """K3 (whole grid, guard frame and periodic; its sharded mode), K6 and
    K9 on three members, each in one launch."""
    st = port.make_stencil(name, dtype=dtype)
    if fused.margin_of(st, k) is None:
        pytest.skip(f"{name} {dtype} takes no k = {k} on K3")
    m = fused.k_step_margin(st, k)
    atol = _window_atol(st)
    shape = (40, 36, 70)
    fields = _members(st, shape, dev, 2500)
    for periodic in (False, True) if name != "sor3d" else (False,):
        fused.launches.clear()
        got = fused.fused_step(fields, st, k, periodic)
        torch.cuda.synchronize()
        _one_launch(fused.launches, _ens_key("fused_step", st))
        _close(got, fused.plain_steps(fields, st, k, periodic), atol)
        _same_bits(got, _per_member(
            lambda *f: fused.fused_step(f, st, k, periodic), *fields))
    padded = _members(st, (40 + 2 * m, 36 + 2 * m, 70), dev, 2501)
    gshape, org = (120, 72, 70), (40, 36)
    fused.launches.clear()
    got = fused.fused_step_padded(padded, st, k, gshape, org)
    torch.cuda.synchronize()
    _one_launch(fused.launches, _ens_key("fused_step_padded", st))
    _close(got, fused.plain_step_padded(padded, st, k, gshape, org), atol)
    _same_bits(got, _per_member(
        lambda *p: fused.fused_step_padded(p, st, k, gshape, org), *padded))
    core, lo, hi = (_members(st, s, dev, 2502 + i) for i, s in
                    enumerate((shape, (m,) + shape[1:], (m,) + shape[1:])))
    fused.launches.clear()
    got = fused.fused_zslab(core, lo, hi, st, k, 120, 40)
    torch.cuda.synchronize()
    _one_launch(fused.launches, _ens_key("fused_zslab", st))
    _close(got, fused.plain_zslab(core, lo, hi, st, k, 120, 40), atol)
    _same_bits(got, _per_member(
        lambda c, a, b: fused.fused_zslab(c, a, b, st, k, 120, 40),
        core, lo, hi))
    Lz, Ly, X = shape
    pieces = [_members(st, s, dev, 2510 + i) for i, s in enumerate(
        ((m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X))
        + ((m, m, X),) * 4)]
    args = (core, *pieces[:4], pieces[4:])
    fused.launches.clear()
    got = fused.fused_yzslab(*args, st, k, gshape, org)
    torch.cuda.synchronize()
    _one_launch(fused.launches, _ens_key("fused_yzslab", st))
    _close(got, fused.plain_yzslab(*args, st, k, gshape, org), atol)
    _same_bits(got, _per_member(
        lambda c, zl, zh, yl, yh, cs: fused.fused_yzslab(
            c, zl, zh, yl, yh, cs, st, k, gshape, org), *args))


ENS_STEPPERS = [("plain", None, (2, 2), False), ("pallas", None, (2, 2), True),
                ("fuse", None, (2, 2), False), ("fuse", None, (2, 2), True),
                ("fuse", "padfree", (4,), False),
                ("fuse", "padfree", (2, 2), True),
                ("fuse", "stream", (4,), False),
                ("fuse", "stream", (2, 2), True),
                ("rdma", "stream", (2, 2), False),
                ("rdma", "stream", (4,), True)]


@pytest.mark.parametrize("mode,kind,mesh_shape,overlap", ENS_STEPPERS,
                         ids=[f"{m}-{k}-{'x'.join(map(str, s))}"
                              f"{'-overlap' if o else ''}"
                              for m, k, s, o in ENS_STEPPERS])
def test_ensemble_sharded_steps_match_members_and_launch_as_one(
        dev, mode, kind, mesh_shape, overlap):
    """The batched sharded steps on virtual shards of one card: each member
    bit-equal to the unbatched step's run of it, and the launches a step
    those of one member's step (the ",ensemble" keys)."""
    st = port.make_stencil("heat3d")
    shape, k = (96, 64, 128), 4
    mesh = make_mesh(mesh_shape, [dev] * 4)

    def build(ens):
        if mode in ("plain", "pallas"):
            return make_sharded_step(
                st, mesh, shape, overlap=overlap, ensemble=ens,
                compute_fn=kernels.make_pallas_compute(st, device=dev)
                if mode == "pallas" else None)
        return make_sharded_fused_step(
            st, mesh, shape, k, kind=kind, overlap=overlap, ensemble=ens,
            exchange="rdma" if mode == "rdma" else None, device=dev)

    batched, single = build(ENS_N), build(0)
    whole = _members(st, shape, dev, 2600)
    counters = (kernels.launches, fused.launches, streamfused.launches,
                remote.launches)
    for c in counters:
        c.clear()
    out = gather_fields(batched(batched(shard_fields(whole, mesh, 3,
                                                     ensemble=True))))
    torch.cuda.synchronize()
    def tally():
        # the ring's keys name its slab shape, which a batch flattens
        out = {key: n for c in counters for key, n in c.items()
               if not key.startswith("ring_")}
        out["ring_exchange"] = sum(n for key, n in remote.launches.items()
                                   if key.startswith("ring_"))
        return out

    got_n = {key.replace(",ensemble", ""): n for key, n in tally().items()}
    for i in range(ENS_N):
        for c in counters:
            c.clear()
        ref = gather_fields(single(single(shard_fields(
            tuple(f[i].contiguous() for f in whole), mesh, 3))))
        torch.cuda.synchronize()
        _same_bits(tuple(o[i] for o in out), ref)
    got_1 = tally()
    assert got_n == got_1
    assert (got_1["ring_exchange"] > 0) == (mode == "rdma")
    assert (len(got_1) > 1) == (mode != "plain")
