"""K1: the fleet Riccati backward sweep as a hand-written CUDA kernel.

Replaces the TPU kernel `experiments/pallas_fleet.py::riccati_sweep_pallas`
(`_sweep_kernel`, `gj_solve2`): from the terminal expansion (lxN, lxxN), each
scenario runs the N-knot recursion over precomputed expansions, forms the
Q-terms, solves (Quu + reg·I)·[d K] = [Qu Qux] by Gauss-Jordan without
pivoting, updates and symmetrises (Vx, Vxx), and accumulates dV1, dV2 and
max|Qu|.

What bounds it on the H100: bytes. Each input is read once and each output
written once, B·sizeof(T)·(756·N + 160) bytes in all at ne = nu = 12 (`work`),
which at the card's 3.35 TB/s takes longer than its ~18.9k multiply-adds a
knot at the peak rate outside the tensor cores (TF32 breaks the solver's convergence, and
the matrices are 12 wide). Every scenario is a serial chain of N knots, so
the design has to hide that chain's latency and that of its loads.

Design (csrc/riccati_sweep.cu): one body templated on (ne, nu). A scenario
has a warp at ne = 12, a group of 8 or 4 lanes of one below; a block of 256
threads owns a tile of scenarios. The lanes share the products (at most 2x3
outputs a lane) and run the Gauss-Jordan in registers, a column or two a
lane, the pivot column broadcast by shuffles in the group, in the plain
version's order. The working set lives in shared memory. Each knot's slabs
are staged once by the whole block with element-wide cp.async (coalesced
along B, transposed on the way in, any B, the ragged tile masked), two
stages deep: knot k-1 loads under knot k's arithmetic. K and d leave through
a double-buffered shared tile, written coalesced along B. Float and double.

The device code is instantiated at the repo's problems' shapes
(`INSTANTIATIONS`: 12 x 12, 12 x 6, 6 x 3, 4 x 2, 2 x 1; with the cross term
``luxs`` (N, nu, ne, B), Qux = lux + BᵀVxxA, of a problem with state rows at
12 x 12 and 4 x 2, one more slab staged a knot). Any other shape up to
12 x 12 (the TPU kernel is generic) is embedded by the wrapper (`embed`) in
the smallest instantiation that holds it: zeros in the added rows and
columns of As, Bs, lxs, lxxs, lus, lxN, lxxN and the identity on the added
diagonal of luus. The elimination runs the columns in order without
pivoting and the added rows and columns couple to nothing, so the live block
of Ks and ds, and dV1, dV2 and max|Qu|, are those of the problem at its own
size.

Source `csrc/riccati_sweep.cu`, compiled at first use with nvcc into
`build/` (`kernels.build`, keyed by a hash of source and flags) and bound
with ctypes.
`riccati_sweep` takes the plain version `riccati_sweep_ref` for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build

# Module import (not names): solver.fleet imports this module too.
from quaternion_mpc_tpu_torch.solver import fleet as _fl

NE = 12
NU = 12
SOURCE = _build.CSRC / "riccati_sweep.cu"
_ENTRY = {torch.float32: "riccati_sweep_f32", torch.float64: "riccati_sweep_f64"}
# (ne, nu, lux) of the device code's instantiations (`K1_SHAPES` in the source)
INSTANTIATIONS = ((12, 12, False), (12, 12, True), (12, 6, False), (6, 3, False),
                  (4, 2, False), (4, 2, True), (2, 1, False))


def build():
    """Compile the kernel (kernels.build); returns the library's path."""
    return _build.build(SOURCE)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.riccati_sweep_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.riccati_sweep_smem_bytes.restype = ctypes.c_int
    lib.riccati_sweep_shapes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.riccati_sweep_shapes.restype = ctypes.c_int
    shapes = (ctypes.c_int * (3 * len(INSTANTIATIONS)))()
    count = lib.riccati_sweep_shapes(shapes, len(shapes))
    built = {(shapes[3 * i], shapes[3 * i + 1], bool(shapes[3 * i + 2])) for i in range(count)}
    if count != len(INSTANTIATIONS) or built != set(INSTANTIATIONS):
        raise RuntimeError(f"{SOURCE.name} is built at {count} shapes, not at INSTANTIATIONS")
    return lib


def shared_bytes(dtype, lux: bool = False, ne: int = NE, nu: int = NU) -> int:
    """Dynamic shared memory of one block of the instantiation at (ne, nu),
    as compiled."""
    return _lib().riccati_sweep_smem_bytes(int(dtype == torch.float64), ne, nu, int(lux))


@functools.cache
def instantiation(ne: int, nu: int, lux: bool = False) -> tuple[int, int]:
    """(NE, NU) of the instantiation a problem at (ne, nu) is launched at:
    its own where there is one, else the one that holds it with the fewest
    values a knot (`embed`)."""
    holds = [(e, u) for e, u, x in INSTANTIATIONS if x == lux and e >= ne and u >= nu]
    return min(holds, key=lambda s: (work(1, 1, torch.float32, *s, lux)["bytes"], s))


def macs_per_knot(ne: int = NE, nu: int = NU) -> int:
    """Multiply-adds of one knot of one scenario at (ne, nu): the nine
    products (AᵀVxx, BᵀVxx, the three Q-matrices, KᵀQuu and the three terms
    of Vxx), the nu x (nu + 1 + ne) Gauss-Jordan (pivot step j updates nu - 1
    rows of nu + ne - j columns), five matrix-vector products (Qx, Qu, three
    terms of Vx), and Quu·d, d·Qu, d·Quu·d."""
    products = 2 * ne**3 + 5 * ne * ne * nu + 2 * ne * nu * nu
    solve = sum((nu - 1) * (nu + ne - j) for j in range(nu))
    return products + solve + ne * ne + 4 * ne * nu + nu * nu + 2 * nu


def work(N: int, B: int, dtype, ne: int = NE, nu: int = NU, lux: bool = False) -> dict:
    """Bytes and floating-point operations that the function needs at (ne, nu),
    for its bound on the card: the problem's own, whatever size the device
    code runs it at (pass ne = nu = 12 for an embedded launch as it is made).
    Bytes: every input read once and every output written once: per scenario
    and knot As, lxxs (ne² each), Bs (ne·nu), luus (nu²), lxs (ne), lus (nu)
    and with ``lux`` luxs (nu·ne) in, Ks (nu·ne) and ds (nu) out; per scenario
    lxN, lxxN, reg in and dV1, dV2, gmax out. Operations: two for each
    multiply-add."""
    per_knot = 2 * ne * ne + ne * nu + nu * nu + ne + nu + nu * ne + nu + lux * nu * ne
    per_scenario = ne + ne * ne + 1 + 3
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {
        "bytes": B * itemsize * (N * per_knot + per_scenario),
        "flops": 2 * macs_per_knot(ne, nu) * N * B,
    }


def check_expansions(As, Bs, lxs, lxxs, lus, luus, lxN, lxxN, reg, what="riccati_sweep",
                     fixed_size=False, luxs=None):
    """Raise on inputs the sweep's interface does not take; returns (ne, nu).
    ``fixed_size`` holds them to ne = nu = 12 (`kernels.assoc_scan` checks
    its fused entry, which has the same interface but does not embed, with
    this too)."""
    if As.dim() != 4 or Bs.dim() != 4:
        raise ValueError(
            f"As must be (N, ne, ne, B) and Bs (N, ne, nu, B), got {tuple(As.shape)} "
            f"and {tuple(Bs.shape)}"
        )
    N, ne, B = As.shape[0], As.shape[1], As.shape[-1]
    nu = Bs.shape[2]
    if fixed_size and (ne, nu) != (NE, NU):
        raise ValueError(
            f"{what} is built for ne = nu = {NE} only (the sweep backend takes "
            f"smaller problems), got ne = {ne}, nu = {nu}"
        )
    if not (1 <= ne <= NE and 1 <= nu <= NU):
        raise ValueError(f"{what} takes 1 <= ne <= {NE} and 1 <= nu <= {NU}, got {ne}, {nu}")
    expected = {
        "As": (As, (N, ne, ne, B)),
        "Bs": (Bs, (N, ne, nu, B)),
        "lxs": (lxs, (N, ne, B)),
        "lxxs": (lxxs, (N, ne, ne, B)),
        "lus": (lus, (N, nu, B)),
        "luus": (luus, (N, nu, nu, B)),
        "lxN": (lxN, (ne, B)),
        "lxxN": (lxxN, (ne, ne, B)),
        "reg": (reg, (B,)),
    }
    if luxs is not None:
        expected["luxs"] = (luxs, (N, nu, ne, B))
    if As.dtype not in _ENTRY:
        raise ValueError(f"{what} takes float32 or float64, got {As.dtype}")
    if B < 1:
        raise ValueError(f"{what} needs at least one scenario")
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != As.dtype or t.device != As.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; As is {As.dtype} on {As.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ne, nu


@functools.cache
def _added_diagonal(nu: int, size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(size, size, 1): ones on the diagonal entries an embedded luus adds."""
    diag = torch.zeros((size,), dtype=dtype, device=device)
    diag[nu:] = 1.0
    return torch.diag(diag)[..., None]


def embed(As, Bs, lxs, lxxs, lus, luus, lxN, lxxN, reg, luxs=None, size=(NE, NU)):
    """The expansions of a problem with ne, nu <= size as those of a
    size[0] x size[1] one with the same live gains: zeros in the added rows
    and columns, the identity on the added diagonal of luus (so that Quu +
    reg·I stays regular; its added rows have zero right-hand sides and solve
    to zero). With ``luxs`` the embedded cross term comes back as a tenth
    tensor."""
    ne, nu = As.shape[1], Bs.shape[2]
    de, du = size[0] - ne, size[1] - nu
    pad = torch.nn.functional.pad
    # pad takes the last axis first: (B: 0, 0), then columns, then rows
    big = (
        pad(As, (0, 0, 0, de, 0, de)),
        pad(Bs, (0, 0, 0, du, 0, de)),
        pad(lxs, (0, 0, 0, de)),
        pad(lxxs, (0, 0, 0, de, 0, de)),
        pad(lus, (0, 0, 0, du)),
        pad(luus, (0, 0, 0, du, 0, du)) + _added_diagonal(nu, size[1], As.device, As.dtype),
        pad(lxN, (0, 0, 0, de)),
        pad(lxxN, (0, 0, 0, de, 0, de)),
        reg,
    )
    return big if luxs is None else big + (pad(luxs, (0, 0, 0, de, 0, du)),)


def riccati_sweep(As, Bs, lxs, lxxs, lus, luus, lxN, lxxN, reg, luxs=None):
    """Riccati sweep over precomputed expansions.

    Shapes (1 <= ne, nu <= 12): As (N, ne, ne, B), Bs (N, ne, nu, B),
    lxs (N, ne, B), lxxs (N, ne, ne, B), lus (N, nu, B), luus (N, nu, nu, B),
    lxN (ne, B), lxxN (ne, ne, B), reg (B,), and for a problem with state
    rows the cost's cross term luxs (N, nu, ne, B); all contiguous, one dtype
    (float32 or float64), one device.
    Returns (Ks (N, nu, ne, B), ds (N, nu, B), dV1 (B,), dV2 (B,), gmax (B,));
    on the card a problem at its own instantiation's size is launched as it
    is, any other embedded (`instantiation`), and its Ks and ds are views of
    the launch's outputs.
    """
    inputs = (As, Bs, lxs, lxxs, lus, luus, lxN, lxxN, reg)
    ne, nu = check_expansions(*inputs, luxs=luxs)
    if As.device.type == "cpu":
        return riccati_sweep_ref(*inputs, luxs=luxs)
    if As.device.type != "cuda":
        raise ValueError(f"riccati_sweep runs on cpu or cuda tensors, not {As.device}")
    size = instantiation(ne, nu, luxs is not None)
    if size != (ne, nu):
        inputs = embed(*inputs, luxs=luxs, size=size)
        if luxs is not None:
            inputs, luxs = inputs[:9], inputs[9]
    N, B = As.shape[0], As.shape[-1]
    Ks = torch.empty((N, size[1], size[0], B), dtype=As.dtype, device=As.device)
    ds = torch.empty((N, size[1], B), dtype=As.dtype, device=As.device)
    dV1, dV2, gmax = (torch.empty_like(reg) for _ in range(3))
    outputs = (Ks, ds, dV1, dV2, gmax)
    # the C interface takes luxs after luus, null without the cross term
    pointers = [t.data_ptr() for t in inputs[:6]] + [None if luxs is None else luxs.data_ptr()]
    pointers += [t.data_ptr() for t in inputs[6:] + outputs]
    fn = getattr(_lib(), _ENTRY[As.dtype])
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*size, *pointers, N, B, stream)
    if err != 0:
        raise RuntimeError(f"riccati_sweep kernel launch at {size} failed with CUDA error {err}")
    riccati_sweep.launches += 1
    if size != (ne, nu):
        return (Ks[:, :nu, :ne], ds[:, :nu], dV1, dV2, gmax)
    return outputs


riccati_sweep.launches = 0


def riccati_sweep_ref(As, Bs, lxs, lxxs, lus, luus, lxN, lxxN, reg, luxs=None):
    """Plain PyTorch version of the same recursion, knot by knot on
    batch-last tensors (the TPU kernel's `_sweep_kernel`; fleet.py
    riccati_step's update), at any (ne, nu). dV1, dV2 and max|Qu| accumulate
    from the last knot backwards, as the kernels do.

    ``luxs`` (N, nu, ne, B) is the cost's cross term, which only a problem
    with state rows has."""
    bmm, bmv, bt = _fl.bmm, _fl.bmv, _fl.bt
    N = As.shape[0]
    eye_u = torch.eye(Bs.shape[2], dtype=As.dtype, device=As.device)[..., None]
    Vx, Vxx = lxN, lxxN
    dV1 = torch.zeros_like(reg)
    dV2 = torch.zeros_like(reg)
    gmax = torch.zeros_like(reg)
    Ks, ds = [None] * N, [None] * N
    for k in reversed(range(N)):
        A, B_ = As[k], Bs[k]
        AtV = bmm(bt(A), Vxx)
        BtV = bmm(bt(B_), Vxx)
        Qx = lxs[k] + bmv(bt(A), Vx)
        Qu = lus[k] + bmv(bt(B_), Vx)
        Qxx = lxxs[k] + bmm(AtV, A)
        Quu = luus[k] + bmm(BtV, B_)
        Qux = bmm(BtV, A)
        if luxs is not None:
            Qux = luxs[k] + Qux
        d, K = _fl.solve_spd_multi(Quu + reg * eye_u, [Qu, Qux])
        d, K = -d, -K
        KtQuu = bmm(bt(K), Quu)
        Vx = Qx + bmv(KtQuu, d) + bmv(bt(K), Qu) + bmv(bt(Qux), d)
        Vxx = Qxx + bmm(KtQuu, K) + bmm(bt(K), Qux) + bmm(bt(Qux), K)
        Vxx = 0.5 * (Vxx + bt(Vxx))
        dV1 = dV1 + torch.sum(d * Qu, dim=0)
        dV2 = dV2 + 0.5 * torch.sum(d * bmv(Quu, d), dim=0)
        gmax = torch.maximum(gmax, torch.amax(torch.abs(Qu), dim=0))
        Ks[k], ds[k] = K, d
    return torch.stack(Ks), torch.stack(ds), dV1, dV2, gmax
