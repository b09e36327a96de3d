"""Device grid + sharded codec dispatch: the codec's dp/sp scale-out axes.

Counterpart of chubaofs_tpu/parallel/mesh.py. The JAX package lays a
jax.sharding.Mesh over its devices and runs each sharded step as one
jax.shard_map program, driven by one process. The port keeps that single
controller and needs no process group: a CodecMesh is a (dp, sp) grid of
torch devices, and the calling process splits each batch into blocks,
copies each block to its device, runs the block's GF products there on the
device's current stream, and gathers the blocks back.

  * ``dp`` (data/stripe parallel): the batch's stripes split over the
    grid's rows; the analog of the reference's per-blob goroutines.
  * ``sp`` (shard-length parallel): each stripe's byte columns split over
    the grid's columns. GF math is column-independent, so encode and repair
    need no communication; only verify's AND over sp crosses devices. It is
    gathered onto each dp row's first device: the all-reduce of a single
    controller.

Every GF product of a CUDA grid runs on B1 (ops/cuda_gf.py::gf_matmul), once
per block, whatever CFS_GF_PIPELINED says (the JAX mesh, too, calls its
fused kernel directly); a CPU grid runs B1's plain version,
rs.gf_matmul_bytes. A device may repeat in a grid, as JAX's virtual CPU
devices do: the tests use eight CPU entries, and a host with one card can
lay a 2 x 2 grid over it. Blocks on one device then run one after another
on its stream: correct, and no faster than one block.

Column split: the sp boundaries fall on multiples of COL_ALIGN bytes, so
every block but the last has 16-byte aligned rows and takes B1's aligned
path (cuda_gf.aligned); only the last block carries a ragged tail. Nothing
is padded, so results are byte-equal whatever the split. Each block is
copied contiguous on the host before it goes to its device: no strided
view reaches the kernel. The TPU's 128-lane padding and its MXU group cap
(pallas_gf.pick_group) do not port, so sharded_gf_matmul always runs g = 1;
sharded_codec_step(group=g) keeps the grouped layout for byte parity with
the reference.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from chubaofs_tpu_torch.ops import cuda_gf, rs

COL_ALIGN = 16  # bytes: B1's aligned path wants each row on 16 bytes
STRIPES = ("dp", None, "sp")  # spec of a (B, rows, k) array on the grid
PER_STRIPE = ("dp",)  # spec of a (B,) array: one block per dp row

# one block of a ShardedArray, as jax.Array.addressable_shards lists them:
# its device, its index into the global array (a tuple of slices) and its
# tensor
Shard = collections.namedtuple("Shard", "device index data")


class CodecMesh:
    """A (dp, sp) grid of torch devices. ``devices`` is the dp x sp object
    array, ``shape`` maps each axis name to its size (as a jax Mesh)."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "sp": devices.shape[1]}

    @property
    def platform(self) -> str:
        """The grid's device type: "cuda" or "cpu"."""
        return self.devices.flat[0].type

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    def synchronize(self) -> None:
        """Wait for every CUDA device's current stream (each one, not only
        the caller's current device)."""
        for d in self.distinct_devices():
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def __repr__(self) -> str:
        return (f"CodecMesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def as_device(d) -> torch.device:
    """torch.device(d), with a bare "cuda" resolved to the current index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def codec_mesh(devices=None, dp: int | None = None,
               sp: int | None = None) -> CodecMesh:
    """Build a (dp, sp) grid over the given devices (default: every CUDA
    device; with none this raises, there is no host fallback). A device may
    repeat. With neither axis named, sp = 2 when the count is even and > 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=[torch.device('cpu')] "
                "* n to lay a grid over the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [as_device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a grid needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a grid holds devices of one type, got {devices}")
    if dp is None and sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.empty((dp, sp), dtype=object)
    for i in range(dp):
        for j in range(sp):
            arr[i, j] = devices[i * sp + j]
    return CodecMesh(arr)


# -- splits ------------------------------------------------------------------------


def row_bounds(b: int, dp: int) -> list[tuple[int, int]]:
    """[(r0, r1)] of each dp row: b stripes in equal parts (b must divide,
    as a NamedSharding over dp requires)."""
    if b % dp:
        raise ValueError(f"{b} stripes do not split over dp={dp}")
    step = b // dp
    return [(i * step, (i + 1) * step) for i in range(dp)]


def col_bounds(k: int, sp: int) -> list[tuple[int, int]]:
    """[(c0, c1)] of each sp column: boundaries on multiples of COL_ALIGN,
    so only the last block carries the ragged tail (a block may be empty
    when k is small)."""
    step = -(-(-(-k // sp)) // COL_ALIGN) * COL_ALIGN
    return [(min(j * step, k), min((j + 1) * step, k)) for j in range(sp)]


# -- sharded arrays ----------------------------------------------------------------


class ShardedArray:
    """A global array held as blocks on a grid's devices.

    spec STRIPES: blocks[i][j] holds rows[i] x every shard row x cols[j] of a
    (B, rows, k) uint8 array, on mesh.devices[i, j]. spec PER_STRIPE:
    blocks[i][0] holds rows[i] of a (B,) array, on mesh.devices[i, 0].
    np.asarray() gathers it to the host; [a:b] slices the leading axis."""

    def __init__(self, mesh: CodecMesh, blocks: list[list[torch.Tensor]],
                 rows: list[tuple[int, int]], cols: list[tuple[int, int]] | None,
                 spec: tuple = STRIPES):
        self.mesh, self.blocks, self.rows, self.cols, self.spec = (
            mesh, blocks, rows, cols, spec)
        first = blocks[0][0]
        lead = (rows[-1][1],)
        self.shape = lead if cols is None else (
            lead + tuple(first.shape[1:-1]) + (cols[-1][1],))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _index(self, i: int, j: int) -> tuple:
        rows = slice(*self.rows[i])
        if self.cols is None:
            return (rows,)
        return (rows, *[slice(None)] * (self.ndim - 2), slice(*self.cols[j]))

    @property
    def addressable_shards(self) -> list[Shard]:
        return [Shard(self.mesh.devices[i, j], self._index(i, j), t)
                for i, row in enumerate(self.blocks) for j, t in enumerate(row)]

    @property
    def device_set(self) -> set[torch.device]:
        return {s.data.device for s in self.addressable_shards}

    def numpy(self) -> np.ndarray:
        """Gather every block to the host: each CUDA block into page-locked
        memory on its device's stream, every stream synchronized, then one
        host array assembled."""
        staged = []
        for s in self.addressable_shards:
            t = s.data
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t = host
            staged.append((s.index, t))
        self.mesh.synchronize()
        out = None
        for index, t in staged:
            block = t.numpy()
            if out is None:
                out = np.empty(self.shape, block.dtype)
            out[index] = block
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __getitem__(self, idx):
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise TypeError("a ShardedArray slices its leading axis with [a:b] "
                            "only; np.asarray() it for any other index")
        start, stop, _ = idx.indices(self.shape[0])
        stop = max(start, stop)
        blocks, rows = [], []
        for (r0, r1), row in zip(self.rows, self.blocks):
            lo, hi = min(max(r0, start), stop), max(min(r1, stop), start)
            hi = max(lo, hi)
            blocks.append([t[lo - r0:hi - r0] for t in row])
            rows.append((lo - start, hi - start))
        return ShardedArray(self.mesh, blocks, rows, self.cols, self.spec)


def _host_stripes(stripes) -> np.ndarray:
    arr = np.asarray(stripes)
    if arr.dtype != np.uint8 or arr.ndim != 3:
        raise ValueError(f"want (B, n, k) uint8 stripes, got {arr.dtype} "
                         f"{arr.shape}")
    return arr


def _place(mesh: CodecMesh, host: np.ndarray, rows, cols) -> ShardedArray:
    """Copy each block of a host (B, n, k) array to its device: contiguous
    on the host first (a column block of a stripe is strided), through
    page-locked memory for a CUDA device, on that device's current stream."""
    blocks = []
    for i, (r0, r1) in enumerate(rows):
        row = []
        for j, (c0, c1) in enumerate(cols):
            dev = mesh.devices[i, j]
            part = host[r0:r1, :, c0:c1]
            if dev.type == "cuda":
                staged = rs.host_buffer(part.shape, dev)
                staged.numpy()[...] = part
                row.append(staged.to(dev, non_blocking=True))
            else:
                row.append(torch.from_numpy(np.array(part, order="C")).to(dev))
        blocks.append(row)
    return ShardedArray(mesh, blocks, rows, cols, STRIPES)


def shard_stripes(mesh: CodecMesh, stripes) -> ShardedArray:
    """Place (B, n, k) stripes: B over dp (B must divide), k over sp, the
    shard axis whole. Host data goes straight to each block's device."""
    host = _host_stripes(stripes)
    return _place(mesh, host, row_bounds(host.shape[0], mesh.shape["dp"]),
                  col_bounds(host.shape[2], mesh.shape["sp"]))


# -- the group view (host-boundary reshapes, kept for byte parity) -----------------


def group_view(data: np.ndarray, g: int) -> np.ndarray:
    """Host-boundary group view: (B, n, k) -> (B/g, g*n, k), a free numpy
    reshape."""
    b, n, k = data.shape
    assert b % g == 0, (b, g)
    return data.reshape(b // g, g * n, k)


def ungroup_stripe(stripe: np.ndarray, g: int, n: int, m: int,
                   b: int | None = None) -> np.ndarray:
    """Host-boundary inverse for encoded stripes: grouped (B/g, g*n + g*m, k)
    -> per-stripe (B, n+m, k). The grouped layout keeps the g stripes' data
    rows first and their parity rows after (block order), so the split is two
    views plus one concatenate. Pass ``b`` (the original stripe count) to
    drop the zero-padding stripes an uneven batch leaves inside the final
    group."""
    stripe = np.asarray(stripe)
    bg, rows, k = stripe.shape
    assert rows == g * (n + m), (stripe.shape, g, n, m)
    data = stripe[:, : g * n, :].reshape(bg * g, n, k)
    par = stripe[:, g * n :, :].reshape(bg * g, m, k)
    out = np.concatenate([data, par], axis=1)
    return out[:b] if b is not None else out


def _grouped_row(s: int, gi: int, g: int, n: int, m: int) -> int:
    """Stripe-local shard index s (0..n+m) of slab gi -> grouped stripe row."""
    return gi * n + s if s < n else g * n + gi * m + (s - n)


# -- the GF product on each block --------------------------------------------------


def _select_gf(mesh: CodecMesh, fused: bool | None, interpret: bool):
    """(gf, use_fused) for this grid, keyed off the GRID's device type.

    fused=None: B1 on a CUDA grid, its plain version on a CPU grid.
    fused=False: the plain version on any grid (the caller asked for it).
    fused=True: B1; a CPU grid has no B1 and raises. interpret=True is
    accepted for API parity with the JAX package: on a CPU grid it names
    B1's plain version (the counterpart of Pallas interpret mode); a CUDA
    grid raises, since there it would mean not running the kernel. Nothing
    switches quietly."""
    platform = mesh.platform
    if platform == "cuda":
        if interpret:
            raise ValueError("interpret=True names B1's plain version, which "
                             "runs on a CPU grid; a CUDA grid runs B1")
        use_fused = fused is not False
    elif platform == "cpu":
        if fused and not interpret:
            raise ValueError("fused=True needs a CUDA grid: B1 has no CPU "
                             "build (interpret=True names its plain version)")
        use_fused = False
    else:
        raise ValueError(f"no GF(2^8) product for a {platform} grid")

    def gf(mat_bits, x: torch.Tensor) -> torch.Tensor:
        if use_fused:
            return cuda_gf.gf_matmul(mat_bits, x)
        return rs.gf_matmul_bytes(mat_bits, x)

    return gf, use_fused


def sharded_gf_matmul(mesh: CodecMesh, *, fused: bool | None = None,
                      interpret: bool = False):
    """Grid-wide drop-in for ``rs.gf_matmul_hostbatch``: host (B, n, k)
    batches x a byte-major bit matrix -> host (B, r, k), B split over ``dp``
    (padded with zero stripes to a multiple of dp, sliced back out) and k
    over ``sp``. This is how CodecService(mesh=...) — and so the whole
    blobstore data plane above it — runs on more than one device: the
    service stays one queue, and every drained batch fans out over the grid.

    Each block goes to its device through page-locked memory, B1 runs on it
    there, and it comes back; every device's stream is synchronized before
    the host result is assembled."""
    gf, _ = _select_gf(mesh, fused, interpret)
    dp = mesh.shape["dp"]

    def run(mat_bits, batch) -> np.ndarray:
        batch = _host_stripes(batch)
        mat_bits = np.asarray(rs.to_numpy(mat_bits), np.int8)
        b, n, k = batch.shape
        r = mat_bits.shape[0] // 8
        if b == 0 or r == 0 or k == 0:
            return np.zeros((b, r, k), np.uint8)
        pad_rows = (-b) % dp
        if pad_rows:  # zero stripes encode trivially; sliced back out below
            batch = np.concatenate([batch, np.zeros((pad_rows, n, k), np.uint8)])
        placed = shard_stripes(mesh, batch)
        out = ShardedArray(mesh, [[gf(mat_bits, t) for t in row] for row in placed.blocks],
                           placed.rows, placed.cols)
        return out.numpy()[:b]

    return run


def sharded_codec_step(
    mesh: CodecMesh, n: int, m: int, *, fused: bool | None = None,
    interpret: bool = False, group: int = 1
):
    """The full codec step over the grid: encode -> verify -> repair.

    Returns ``run(data, bad_idx=(0, n))`` mapping (B, n, k) uint8 host data
    stripes to (stripe, ok (B,), repaired) ShardedArrays. Each block runs
    its own encode, verify and repair on its device (three GF products, B1
    on a CUDA grid); verify is row-wise for each stripe, then an AND over
    the sp blocks of each dp row, gathered onto that row's first device.

    ``group=g`` keeps the JAX package's grouped layout: g stripes viewed as
    one (g*n, k) stripe at the host boundary and every matrix kron-stacked;
    the stripe and repaired outputs stay grouped (``ungroup_stripe(out, g,
    n, m, b=B)`` converts them), ``ok`` is per stripe and sliced to B.

    The repair pattern is runtime data via ``repair_plan_padded``: an LRU
    of 64 patterns keeps each plan as numpy and its index tensors placed on
    every grid device, so a new ``bad_idx`` never repeats the per-shape
    setup. ``run.trace_count[0]`` counts those setups (the row and column
    split of a (B, k) shape). Batches that don't divide dp*group are
    zero-padded in and sliced out (zero stripes encode and verify
    trivially)."""
    g = int(group)
    if g < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    host = rs.get_kernel(n, m, "cpu")  # host-side planning only: generator, repair plans
    gn = g * n
    parity_bits = np.asarray(rs.to_numpy(host.parity_bits), np.int8)
    if g > 1:
        parity_bits = np.kron(np.eye(g, dtype=np.int8), parity_bits)
    gf, _ = _select_gf(mesh, fused, interpret)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    trace_count = [0]
    setups: dict[tuple[int, int], tuple[list, list]] = {}

    def setup(b: int, k: int):
        if (b, k) not in setups:
            trace_count[0] += 1
            setups[(b, k)] = (row_bounds(b, dp), col_bounds(k, sp))
        return setups[(b, k)]

    @functools.lru_cache(maxsize=64)
    def plan_for(bad: tuple):
        # once per pattern: the O(n^3) host inversion and the index tensors'
        # copy to every grid device. With group > 1 the plan is kron-stacked
        # and its survivor/missing rows mapped to grouped stripe rows.
        mat, present, missing = host.repair_plan_padded(list(bad))
        mat = np.asarray(rs.to_numpy(mat), np.int8)
        present, missing = rs.to_numpy(present), rs.to_numpy(missing)
        if g > 1:
            mat = np.kron(np.eye(g, dtype=np.int8), mat)
            present = np.asarray([_grouped_row(int(s), gi, g, n, m)
                                  for gi in range(g) for s in present])
            missing = np.asarray([_grouped_row(int(s), gi, g, n, m)
                                  for gi in range(g) for s in missing])
        idx = {d: (torch.as_tensor(present, dtype=torch.int64, device=d),
                   torch.as_tensor(missing, dtype=torch.int64, device=d))
               for d in mesh.distinct_devices()}
        return mat, idx

    def block_step(data, mat, present, missing):
        parity = gf(parity_bits, data)  # (rows, g*m, w) on the block's device
        stripe = torch.cat([data, parity], dim=-2)
        # verify: recompute parity from the stripe's data rows (data holds
        # exactly those bytes, contiguous); row-wise first so ok stays per
        # stripe in the grouped layout
        expect = gf(parity_bits, data)
        eq_rows = (expect == stripe[:, gn:, :]).all(dim=-1)  # (rows, g*m)
        ok = eq_rows.reshape(eq_rows.shape[0], g, m).all(dim=-1).reshape(-1)
        # repair: survivors -> missing rows via the runtime plan
        rows = gf(mat, stripe.index_select(1, present))
        repaired = stripe.clone()
        repaired[:, missing, :] = rows
        return stripe, ok, repaired

    def run(data, bad_idx=(0, n)):
        mat, idx = plan_for(tuple(sorted(set(int(i) for i in bad_idx))))
        data = _host_stripes(data)
        b = data.shape[0]
        pad = (-b) % (dp * g)
        if pad:
            data = np.concatenate([data, np.zeros((pad, *data.shape[1:]), np.uint8)])
        if g > 1:
            data = group_view(data, g)
        rows, cols = setup(data.shape[0], data.shape[2])
        placed = _place(mesh, data, rows, cols)
        stripes, oks, repaireds = [], [], []
        for i, row in enumerate(placed.blocks):
            outs = [block_step(t, mat, *idx[mesh.devices[i, j]])
                    for j, t in enumerate(row)]
            stripes.append([o[0] for o in outs])
            repaireds.append([o[2] for o in outs])
            # verify's AND over sp, gathered onto the row's first device
            ok = outs[0][1]
            for o in outs[1:]:
                ok = ok & o[1].to(ok.device)
            oks.append([ok])
        stripe = ShardedArray(mesh, stripes, rows, cols)
        repaired = ShardedArray(mesh, repaireds, rows, cols)
        ok = ShardedArray(mesh, oks, [(r0 * g, r1 * g) for r0, r1 in rows], None,
                          PER_STRIPE)
        if pad:
            nb = -(-b // g)
            stripe, repaired, ok = stripe[:nb], repaired[:nb], ok[:b]
        return stripe, ok, repaired

    run.trace_count = trace_count
    run.group = g
    return run
