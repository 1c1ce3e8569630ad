"""The Hopper probes P1-P4 (doomtpu_torch/ops/probe_visit.py and
probe_ybounds.py) against the TPU probes they port
(scripts/probe_visit_cost.py, scripts/probe_percam_ybounds.py), whose
kernels run here through `pl.pallas_call(..., interpret=True)` built as
the scripts build them.

- P1: the 17 construct kernels at N = 64 (the script's N monkeypatched),
  the port's plain version at the same N on the same inputs (the port's
  `visit_inputs`, made from a seed with numpy).  The TPU kernels' f32
  dots are exact on the CPU, so the one-pass TF32 constructs are held
  there in their exact form, and in their TF32 form to a numpy emulation
  of cvt.rna.tf32.f32.
- P2 / P3: `main6`'s and `main7`'s kernels against the port's exact
  broadcast and exact3_reference; exact1_reference against the TF32
  emulation; on the control input all of them equal.  At `copies` > 1
  the plain versions and the CPU wrappers stack the one-copy output;
  the wrappers' argument checks; the price of a field's bounds.
- P4: `make_kernel(mode)` for the five modes at S = 16 against
  ybounds_reference; `band` (no TPU body) against a loop.
- P1's bound: the operations each construct needs (NEEDS), by class
  over the H100's per-SM rates; the SASS loop parser behind its
  diagnostic count, on a hand-written listing.

Tolerance: exact equality everywhere (i32 outputs and f32 bit patterns).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from doomtpu_torch.ops import probe_visit as pv  # noqa: E402
from doomtpu_torch.ops import probe_ybounds as pyb  # noqa: E402
from scripts import probe_percam_ybounds as ppy  # noqa: E402
from scripts import probe_visit_cost as pvc  # noqa: E402

N = pv.CHECK_N
S = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(kernel, *inputs, in_specs=None):
    """scripts/probe_visit_cost.py::run's pallas_call, in interpret mode."""
    f = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=in_specs or [
            pl.BlockSpec(x.shape, lambda i, nd=x.ndim: (0,) * nd,
                         memory_space=pltpu.VMEM) for x in inputs
        ],
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(f(*inputs))


def _tpu_kernel(name):
    body = pv.TPU_BODY[name]
    if body.startswith("_mk_branchy"):
        return pvc._mk_branchy("True" in body)
    return getattr(pvc, body)


@pytest.fixture(scope="module")
def inputs():
    return pv.visit_inputs()


@pytest.fixture(scope="module")
def tpu_outputs(inputs):
    """The 17 TPU construct kernels' outputs at N = 64."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pvc, "N", N)
    try:
        out = {}
        for name, body in pv.TPU_BODY.items():
            if body is None:
                continue
            x, t, _ = inputs[name]
            args = [jnp.asarray(x)] + ([] if t is None else [jnp.asarray(t)])
            if name == "branchy_ld":     # the script passes its selectors
                args.append(jnp.asarray(inputs["branchy_mxu"][1]))
            spec = None
            if name == "smem":
                spec = [pl.BlockSpec(x.shape, lambda i: (0, 0),
                                     memory_space=pltpu.SMEM)]
            out[name] = _run(_tpu_kernel(name), *args, in_specs=spec)
        return out
    finally:
        mp.undo()


def _np_tf32(x):
    """numpy emulation of cvt.rna.tf32.f32."""
    b = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return (((b + 0x1000) & ~0x1FFF) & 0xFFFFFFFF).astype(np.uint32).view(
        np.float32)


def _np_tf32_construct(name, x, n):
    """The one-pass TF32 constructs, emulated: field broadcasts of
    TF32-rounded windows (the selectors are the identity / one-hot)."""
    acc = np.zeros((8, 128), np.float32)
    for i in range(n):
        w = x[0, i & 63]
        for f in range(13):
            if name == "mxubcast":
                v = _np_tf32(w)
            elif name == "mxubcast13":
                v = _np_tf32((w + np.float32(f)).astype(np.float32))
            else:
                v = np.broadcast_to(_np_tf32(w)[:, f:f + 1], (8, 128))
            acc = (acc + v).astype(np.float32)
    return acc.astype(np.int32)


def _port(name, inputs, **kw):
    x, t, arg = inputs[name]
    out = pv.construct_reference(
        name, torch.from_numpy(x), None if t is None else torch.from_numpy(t),
        N, arg, **kw)
    assert out.shape == (1, 8, 128) and out.dtype == torch.int32
    return out[0].numpy()


@pytest.mark.parametrize(
    "name", [k for k, v in pv.TPU_BODY.items() if v is not None])
def test_construct_equals_tpu_kernel(name, inputs, tpu_outputs):
    """P1: the plain version of each construct equals its TPU kernel
    (exact products for the one-pass TF32 constructs, as the TPU
    kernel's f32 dot gives them on the CPU)."""
    got = _port(name, inputs, tf32_products=False)
    np.testing.assert_array_equal(got, tpu_outputs[name], name)
    if name in pv.TF32_ONE_PASS:
        np.testing.assert_array_equal(
            _port(name, inputs), _np_tf32_construct(name, inputs[name][0], N),
            f"{name} (TF32)")


def test_hopper_only_constructs_and_wrapper():
    """The constructs with no TPU body against numpy loops, the CPU
    wrapper against the plain version (copies of one output), and its
    argument checks."""
    ins = pv.visit_inputs()
    x, t, _ = ins["gather_l2"]
    u = (x.astype(np.int64) + 1024 * np.arange(3)[:, None, None]) \
        & 0xFFFFFFFF
    for i in range(N):
        h = (u * 0x61C88647 + i) & 0xFFFFFFFF
        u = (u + (t[h >> 12].astype(np.int64) & 0xFFFFFFFF)) & 0xFFFFFFFF
    got = pv.construct("gather_l2", torch.from_numpy(x), torch.from_numpy(t),
                       N, blocks=3, threads=1024)
    np.testing.assert_array_equal(got.numpy(),
                                  u.astype(np.uint32).view(np.int32))
    x, d, _ = ins["fdiv"]
    a = x.copy()
    for _ in range(N * pv.CHAIN):
        a = (a / d).astype(np.float32)
    np.testing.assert_array_equal(_port("fdiv", ins), a.view(np.int32))
    a = x.copy()
    r = ins["fmulrcp"][1]
    for _ in range(N * pv.CHAIN):
        a = (a * r).astype(np.float32)
    np.testing.assert_array_equal(_port("fmulrcp", ins), a.view(np.int32))
    # half the lanes take the branch every iteration
    np.testing.assert_array_equal(_port("branch_div", ins), 1 + N // 2)
    x, t, arg = ins["mxu13hi"]
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    out = pv.construct("mxu13hi", tx, tt, N, arg, blocks=2, threads=256)
    assert out.shape == (4, 8, 128)
    np.testing.assert_array_equal(out[1].numpy(), _port("mxu13hi", ins))
    assert pv.construct("math", torch.ones(8, 128, dtype=torch.int32),
                        n=N, blocks=132 * 4, threads=256).shape == (132, 8, 128)
    with pytest.raises(ValueError):
        pv.construct("math", torch.ones(8, 128, dtype=torch.int32), n=N,
                     threads=512)
    with pytest.raises(ValueError):
        pv.construct("mxu13hi", tx, tt[:128], N)
    with pytest.raises(ValueError):
        pv.construct("math", tx, n=N)


@pytest.mark.parametrize("name, clocks", [
    ("mxubcast", 3328), ("mxubcast13", 3328), ("mxu13diff", 3328),
    ("mxu13hi", 9984), ("mxu48hi", 3744), ("mxu13cvt", 3744),
    ("branchy_mxu", 3744)])
def test_mma_shapes_keep_the_bound(name, clocks, monkeypatch):
    """The tensor-core constructs' two launch shapes on a 132-SM card hold
    2 copies an SM, as their earlier 512-thread copies did (1 x 1024 and
    528 x 256 threads), so their bound (the operations 32 8 x 8 output
    tiles an SM need) is unchanged: 13 products x P passes x K/8 k-steps
    x 512 useful FMAs at 1024 a clock, x 32 tiles."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132}))
    shapes = pv.configs("cuda", name)
    assert shapes == {"one block": (1, 256), "K1 occupancy": (132, 256)}
    assert [pv.copies_of(name, *s) for s in shapes.values()] == [2, 264]
    assert pv.needs_bound(name) == (pytest.approx(clocks), "tensor")
    assert pv.LOOP_TRIPS[name] == (6,)
    # the element constructs keep theirs
    assert pv.configs("cuda", "math") == {"one block": (1, 1024),
                                          "K1 occupancy": (528, 256)}
    with pytest.raises(ValueError):      # blocks of at most 256 threads
        pv.copies_of(name, 1, 512)
    assert pv.copies_of(name, 2, 64) == 1


def test_branchy_mxu_votes_over_a_warps_tile():
    """branchy_mxu's vote group follows its warp, which holds a 32-lane
    group of all 8 rows: one element's test (row 0, lane 40) takes the
    branch for lanes 32-63 of every row, nowhere else."""
    x, t = pv.vote_inputs(40)
    got = pv.construct_reference("branchy_mxu", torch.from_numpy(x),
                                 torch.from_numpy(t), 1)[0].numpy()
    # fields 1-12 pick columns 1-12 of window 0: their sum per row
    tot = x[0, 0, :, 1:13].astype(np.int32).sum(1)[:, None]
    want = np.zeros((8, 128), np.int32)
    want[:, 32:64] = tot
    assert (tot != 0).all()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):      # the variant is mxu13diff / hi's
        pv.construct("branchy_mxu", torch.from_numpy(x), torch.from_numpy(t),
                     1, 0, 4, 256, w_from_smem=True)
    with pytest.raises(ValueError):      # and the staged shape's
        pv.construct("mxu13hi", *(torch.from_numpy(v) for v in
                                  pv.visit_inputs()["mxu13hi"][:2]),
                     1, 0, 3, 256, w_from_smem=True)


def _tpu_exact(w, s, highest):
    """main6's / main7's kernel (the scripts build it inside the main),
    in interpret mode."""
    def kern(w_ref, s_ref, o_ref):
        for f in range(8):
            if highest:
                bc = lax.dot_general(
                    w_ref[...], s_ref[f * 128:(f + 1) * 128, :],
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    precision=lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32,
                )
            else:
                bc = jnp.dot(w_ref[...], s_ref[f * 128:(f + 1) * 128, :])
            o_ref[pl.ds(f * 8, 8), :] = lax.bitcast_convert_type(
                bc, jnp.int32)

    f = pl.pallas_call(
        kern,
        grid=(1,),
        in_specs=[
            pl.BlockSpec((8, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((8 * 128, 128), lambda i: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
        out_specs=pl.BlockSpec((64, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(w), jnp.asarray(s)))


@pytest.mark.parametrize("which", ["f32", "i24", "control"])
def test_exactness_probes_equal_tpu_kernels(which):
    """P2 / P3: main6's and main7's kernels equal the port's exact
    broadcast and P3's plain version bit for bit; P2's plain version
    equals the TF32 emulation; on the control input (exact in TF32) all
    agree."""
    w = pv.exact_inputs()[which]
    s = pv.exact_selectors()
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    exact = pv.broadcast(tw).numpy()
    for highest in (False, True):
        np.testing.assert_array_equal(_tpu_exact(w, s, highest), exact)
    np.testing.assert_array_equal(pv.exact3_reference(tw, ts).numpy(), exact)
    np.testing.assert_array_equal(pv.exact3(tw, ts).numpy(), exact)
    tf = np.repeat(_np_tf32(w)[:, :8].T.reshape(64, 1), 128, 1)
    one = pv.exact1(tw, ts).numpy()
    np.testing.assert_array_equal(one, tf.view(np.int32))
    np.testing.assert_array_equal(one, pv.exact1_reference(tw, ts).numpy())
    if which == "control":
        np.testing.assert_array_equal(one, exact)
    else:
        assert (one != exact).any()   # TF32 drops bits of these inputs


@pytest.mark.parametrize("copies", [2, 5])
@pytest.mark.parametrize("passes", [1, 3])
def test_exact_copies_stack_the_one_copy_output(passes, copies):
    """P2 / P3 at `copies` > 1: the plain versions, and the wrappers on
    CPU tensors (the plain path: no launch counted), return `copies`
    stacked copies of the copies=1 output, [copies, 64, 128], each its
    own memory; with `stored` the first `stored` of them."""
    ref = pv.exact1_reference if passes == 1 else pv.exact3_reference
    fn = pv.exact1 if passes == 1 else pv.exact3
    s = torch.from_numpy(pv.exact_selectors())
    for w_np in pv.exact_inputs().values():
        w = torch.from_numpy(w_np)
        one = ref(w, s)
        assert one.shape == (64, 128) and one.dtype == torch.int32
        assert torch.equal(ref(w, s, 1), one)
        before = fn.launches
        for got in (ref(w, s, copies), fn(w, s, copies)):
            assert got.shape == (copies, 64, 128)
            for c in range(copies):
                assert torch.equal(got[c], one)
            got[0] += 1                     # no slice aliases another
            assert torch.equal(got[1], one)
        for stored in (1, copies - 1):
            for got in (ref(w, s, copies, stored), fn(w, s, copies, stored)):
                assert got.shape == (stored, 64, 128)
                assert all(torch.equal(g, one) for g in got)
        assert torch.equal(fn(w, s), one)
        assert fn.launches == before


@pytest.mark.parametrize("fn", ["exact1", "exact3", "exact1_reference",
                                "exact3_reference"])
def test_exact_argument_checks(fn):
    """copies < 1 (or not an int), stored outside [1, copies] (or not an
    int), a non-contiguous w or s, a wrong shape or dtype: every entry
    point raises."""
    call = getattr(pv, fn)
    s = torch.from_numpy(pv.exact_selectors())
    w = torch.from_numpy(pv.exact_inputs()["control"])
    for copies in (0, -1, 1.0, True, None):
        with pytest.raises(ValueError):
            call(w, s, copies)
    for stored in (0, 4, 2.0):
        with pytest.raises(ValueError):
            call(w, s, 3, stored)
    wide = torch.zeros(8, 256)
    with pytest.raises(ValueError):
        call(wide[:, ::2], s)               # non-contiguous w
    tall = torch.from_numpy(np.repeat(pv.exact_selectors(), 2, 1))
    with pytest.raises(ValueError):
        call(w, tall[:, ::2])               # non-contiguous s
    with pytest.raises(ValueError):
        call(w.t().contiguous(), s)
    with pytest.raises(ValueError):
        call(w.double(), s)
    with pytest.raises(ValueError):
        call(w, s[:128])


def test_field_bounds():
    """The price of a field product's bounds, ns an SM: one (8, 128) x
    (128, 128) product's TF32 FMAs at 1024 a clock (x3 for three
    pieces), and its share of the bytes over 132 SMs, with every copy's
    output written or one."""
    b1 = pv.field_bounds_ns(1, 16384, 132, 1980.0)
    b3 = pv.field_bounds_ns(3, 16384, 132, 1980.0)
    assert b1["fma"] == pytest.approx(131072 / 1024 / 1.98)
    assert b3["fma"] == pytest.approx(3 * b1["fma"])
    fields = 16384 * 8
    want = 4 * (1024 + 131072 + fields * 1024) / 3.35e12 * 1e9 * 132 / fields
    assert b1["bytes"] == pytest.approx(want) == b3["bytes"]
    assert 161 < b1["bytes"] < 162
    one = pv.field_bounds_ns(1, 16384, 132, 1980.0, stored=1)
    want = 4 * (1024 + 131072 + 8192) / 3.35e12 * 1e9 * 132 / fields
    assert one["bytes"] == pytest.approx(want)
    assert one["fma"] == b1["fma"]


@pytest.fixture(scope="module")
def ybounds_inputs():
    return pyb.ybounds_inputs(S)


@pytest.mark.parametrize("mode", ["empty", "union", "percam", "percamS",
                                  "percamR"])
def test_ybounds_equals_tpu_kernel(mode, ybounds_inputs):
    """P4: make_kernel(mode) over S = 16 grid steps, as
    probe_percam_ybounds.main builds it.  The TPU kernel never
    initialises its output; interpret mode fills it with the int32
    minimum, taken off here."""
    lo, hi = ybounds_inputs
    f = pl.pallas_call(
        ppy.make_kernel(mode),
        grid=(S,),
        in_specs=[
            pl.BlockSpec((1, ppy.TB, ppy.LANES), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, ppy.TB, ppy.LANES), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=jax.ShapeDtypeStruct((ppy.TB, ppy.H, ppy.LANES),
                                       jnp.int32),
        out_specs=pl.BlockSpec((ppy.TB, ppy.H, ppy.LANES),
                               lambda i: (0, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((ppy.TB, ppy.LANES), jnp.int32)],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
        interpret=True,
    )
    got = np.asarray(f(jnp.asarray(lo), jnp.asarray(hi))).astype(np.int64)
    want = pyb.ybounds(torch.from_numpy(lo), torch.from_numpy(hi), mode)
    assert want.dtype == torch.int32 and want.shape == (8, 200, 128)
    np.testing.assert_array_equal(got - np.iinfo(np.int32).min,
                                  want.numpy())
    assert want.sum() > 0


@pytest.mark.parametrize("chunks", [1, 3, 7, 64, 150])
def test_ybounds_chunks_sum_to_the_serial_counts(chunks):
    """P4's emissions split into chunks (3, 7 and 64 divide none of S =
    100; 150 leaves chunks empty), each chunk's counts summed: every mode
    equals the unchunked plain version, through the CPU wrapper too."""
    lo, hi = (torch.from_numpy(v) for v in pyb.ybounds_inputs(100))
    for mode in pyb.MODES:
        want = pyb.ybounds_reference(lo, hi, mode)
        assert want.dtype == torch.int32 and want.sum() > 0
        assert torch.equal(pyb.ybounds_reference(lo, hi, mode, chunks), want)
        assert torch.equal(pyb.ybounds(lo, hi, mode, chunks), want)
    for bad in (0, pyb.MAX_CHUNKS + 1, 2.0):
        with pytest.raises(ValueError):
            pyb.ybounds(lo, hi, "union", bad)


def test_ybounds_band_and_checks(ybounds_inputs):
    """P4's `band` mode (K1's mechanism, no TPU body) against a loop, on
    the probe's inputs and on ranges past the screen; the wrapper's
    checks."""
    lo, hi = ybounds_inputs
    lo2 = lo - 30 * (np.arange(S)[:, None, None] % 3 == 0)
    hi2 = hi + 40 * (np.arange(S)[:, None, None] % 2 == 0)
    for a, b in ((lo, hi), (lo2.astype(np.int32), hi2.astype(np.int32))):
        want = np.zeros((8, 200, 128), np.int64)
        for s in range(S):
            for cam in range(8):
                for lane in range(128):
                    y0, y1 = max(a[s, cam, lane], 0), min(b[s, cam, lane], 199)
                    want[cam, y0:y1 + 1, lane] += 1
        got = pyb.ybounds_reference(torch.from_numpy(a), torch.from_numpy(b),
                                    "band")
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        pyb.ybounds(torch.from_numpy(lo), torch.from_numpy(hi), "rows")
    with pytest.raises(ValueError):
        pyb.ybounds(torch.from_numpy(lo), torch.from_numpy(hi[:, :4]), "band")


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_112visit_kernelILi1EEEvNS_4ArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   IMAD R2, R0, 0x3, RZ ;
        /*0030*/                   IMAD R3, R2, 0x3, RZ ;
        /*0040*/                   IMAD R4, R3, 0x3, RZ ;
        /*0050*/              @!P1 BRA `(.L_x_0) ;
        /*0060*/                   LDS R5, [R6] ;
        /*0070*/                   LDS R7, [R6+0x4] ;
        /*0080*/                   IADD3 R5, R5, R7, RZ ;
.L_x_0:
        /*0090*/                   IMAD R8, R4, 0x3, RZ ;
.L_x_2:
        /*00a0*/                   FADD R9, R9, 1 ;
        /*00b0*/              @P3 BRA `(.L_x_2) ;
        /*00c0*/              @!P2 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
                Function : _Z4mainv
        /*0000*/                   EXIT ;
"""


@pytest.mark.parametrize("name, clocks, cls", [
    # 32 warps: 64 shifts and xors a warp at 2 a clock
    ("math", 64 * 32 / 2, "alu"),
    # 13 shuffles a warp at one a clock
    ("lanegather13", 13 * 32, "shfl"),
    # 8 divides of 8 instructions a warp at 4 a clock (their 8
    # reciprocals at 16 lanes a clock tie)
    ("fdiv", 8 * 8 * 32 / 4, "issue"),
    # 13 products of 16 k-steps, 512 useful FMA each, 1024 a clock
    ("mxubcast", 13 * 16 * 512 / 1024 * 32, "tensor"),
    # three passes, and three passes at K = 48
    ("mxu13hi", 3 * 13 * 16 * 512 / 1024 * 32, "tensor"),
    ("branchy_mxu", 3 * 13 * 6 * 512 / 1024 * 32, "tensor"),
])
def test_needs_bound(name, clocks, cls):
    """P1's bound: a construct's needed operations by class over the
    H100's per-SM rates at 32 warps an SM, the class that sets it."""
    assert pv.needs_bound(name) == (pytest.approx(clocks), cls)


def test_needs_cover_every_construct():
    assert set(pv.NEEDS) == set(pv.CONSTRUCTS)
    for name, need in pv.NEEDS.items():
        assert set(need) <= set(pv.RATES) | {"other"}, name
        clocks, _ = pv.needs_bound(name)
        # never fewer clocks than the issue slots of its instructions
        assert clocks >= sum(need.values()) / pv.RATES["issue"] * 32, name
    assert pv.needs_bound("math", warps_per_sm=8)[0] == \
        pytest.approx(pv.needs_bound("math")[0] / 4)


def test_sass_loop_parser():
    """P1's SASS diagnostic: the outermost loop's instructions by depth,
    branch and class; an inner loop counted its trips times, the
    conditional body at the branch's taken share."""
    loops = pv.sass_loops(SASS)
    assert list(loops) == ["_ZN12_GLOBAL__N_112visit_kernelILi1EEEvNS_4ArgsE"]
    c = next(iter(loops.values()))
    assert dict(c) == {(0, False, "imad"): 4, (0, False, "other"): 2,
                       (0, True, "lsu"): 2, (0, True, "alu"): 1,
                       (1, False, "fp32"): 1, (1, False, "other"): 1}
    # an empty inner loop: 4 IMADs a warp at 2 a clock set it (7.5
    # instructions in all at 4 a clock)
    clocks, cls = pv.sass_bound(c, taken=0.5, trips=(0,), warps_per_sm=32)
    assert cls == "imad" and clocks == pytest.approx(4 / 2 * 32)
    # 5 trips of the inner loop: 19 instructions at 4 a clock
    clocks, cls = pv.sass_bound(c, taken=1.0, trips=(5,), warps_per_sm=32)
    assert cls == "issue" and clocks == pytest.approx(19 / 4 * 32)
    with pytest.raises(ValueError):
        pv.sass_bound(c)
    # which function holds a construct's priced loop: visit_kernel<C>, or
    # mma_kernel<C, STAGED = true, V = 0> (nvcc 12.8's mangled names)
    ns = "_ZN47_GLOBAL__N__8a93f11b_14_probe_visit_cu_d707984d"
    assert pv.construct_of(ns + "12visit_kernelILi8EEEvNS_4ArgsE") == "fori0"
    assert pv.construct_of(
        ns + "10mma_kernelILi14ELb1ELi0EEEvNS_4ArgsE") == "mxu13hi"
    for other in ("10mma_kernelILi14ELb1ELi1EEEvNS_4ArgsE",
                  "10mma_kernelILi14ELb0ELi0EEEvNS_4ArgsE",
                  "12exact_kernelILi3EEEvPKfS2_Piii"):
        assert pv.construct_of(ns + other) is None
