"""Cross-shard top-k merge: counterpart of ``raft_tpu/ops/ring_topk.py``
(``merge``, ``merge_step``, ``resolve_engine``, ``ring_capable``,
``per_hop_bytes``, ``gathered_bytes``, ``active_engines``,
``note_engine``).

Every shard of a sharded search holds its (m, k) candidates: distances
and global row ids, a dead shard's rows already (±inf, -1). The merged
answer is the k best cells of the shard-ordered (m, p·k) concatenation
under the total order (±distance, column position), shard s's slot j
sitting at column s·k + j — ``knn_merge_parts``'s order, ties to the
lower shard. Top-k under a total order is associative, so a ring that
folds each arriving block into a running top-k, re-deriving the block's
positions from its origin shard, gives the same k cells in the same order
on every shard. Three engines, one result (one merged copy per shard, the
copies equal):

* ``"allgather"`` — ``comms.allgather`` + ``brute_force.knn_merge_parts``
  on every shard (kernel K1 on CUDA).
* ``"ring"`` — p−1 ``device_sendrecv`` hops, each shard folding the
  arriving block with :func:`merge_step` (kernel K7 on CUDA, p·(p−1)
  launches a merge).
* ``"ring_pallas"`` — kernel K8 (``csrc/ring_topk.cu``): the whole ring in
  one launch, slots and flags in the shards' device memory. The name is
  the JAX package's. On CPU shards its plain version, the ring with the
  plain fold, runs.

``"hier"`` (the multi-host composition) is not ported yet. Nor are
``tune_merge``, the ``RAFT_TPU_SHARDED_MERGE`` variable and the guarded
demotion to allgather: no fallback hides a kernel — a CUDA merge with
``engine="ring_pallas"`` launches K8 or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..comms import AxisComms, Mesh
from ..core.errors import RaftError, expects
from ..utils import cdiv
from . import _cuda

__all__ = ["ENGINES", "ALL_ENGINES", "STEP_MAX_W", "RING_MAX_K",
           "RING_MAX_SHARDS", "RingPlan", "ring_plan", "per_hop_bytes",
           "gathered_bytes", "merge_step", "merge_step_plain", "ring_topk",
           "ring_topk_kernel", "ring_topk_plain", "merge", "ring_capable",
           "resolve_engine", "active_engines", "note_engine"]

ENGINES = ("allgather", "ring", "ring_pallas")
ALL_ENGINES = ENGINES + ("hier",)

STEP_MAX_W = 16_384     # K7: a row's w1 + w2 cells staged in shared memory
RING_MAX_K = 1024       # K8: a warp's 5·k words of shared memory, 4 warps
                        # (its form for k > 256)
RING_MAX_SHARDS = 16    # K8: the kernel's table of per-shard pointers

merge_step_launches = 0   # K7 launches since the last reset
ring_launches = 0         # K8 launches since the last reset


# --------------------------------------------------------------------------
# traffic accounting
# --------------------------------------------------------------------------

def per_hop_bytes(m: int, k: int) -> int:
    """Bytes one shard sends per ring hop: an (m, k) f32 distance block +
    an (m, k) i32 id block."""
    return m * k * (4 + 4)


def gathered_bytes(m: int, k: int, p: int) -> int:
    """Bytes of the (p, m, k) candidate buffer every shard holds under the
    allgather merge (distances + ids)."""
    return p * m * k * (4 + 4)


# --------------------------------------------------------------------------
# the (key, position) fold — kernel K7 and its plain version
# --------------------------------------------------------------------------

def _lex_order(key: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Column order of each row under (key, position, column): a stable
    sort by position, then a stable sort by key — the order of
    ``lax.sort(num_keys=2, is_stable=True)``."""
    by_pos = torch.sort(pos, dim=1, stable=True).indices
    by_key = torch.sort(torch.gather(key, 1, by_pos), dim=1,
                        stable=True).indices
    return torch.gather(by_pos, 1, by_key)


def merge_step_plain(run_d, run_pos, run_gid, blk_d, blk_pos, blk_gid,
                     k: int, select_min: bool = True):
    """Plain version of K7: the k best cells of the (m, w1 + w2)
    concatenation under (±distance, position) → (d, pos, gid), each
    (m, k), best first."""
    d = torch.cat([run_d, blk_d], dim=1)
    pos = torch.cat([run_pos, blk_pos], dim=1)
    gid = torch.cat([run_gid, blk_gid], dim=1)
    order = _lex_order(d if select_min else -d, pos)[:, :k]
    return (torch.gather(d, 1, order), torch.gather(pos, 1, order),
            torch.gather(gid, 1, order))


def merge_step(run_d, run_pos, run_gid, blk_d, blk_pos, blk_gid, k: int,
               select_min: bool = True):
    """One hop's fold, standalone: fold an arriving (m, w2) block into a
    running (m, w1) list under the (±distance, position) total order →
    (d, pos, gid) each (m, k), best first. Neither list need be sorted; a
    cell that is not finite ranks by its position. Kernel K7 on CUDA
    tensors, the plain version on CPU tensors."""
    global merge_step_launches
    args = (run_d, run_pos, run_gid, blk_d, blk_pos, blk_gid)
    if all(t.device.type == "cpu" for t in args):
        return merge_step_plain(*args, k, select_min)
    dev = run_d.device
    expects(all(t.is_cuda and t.device == dev for t in args),
            "merge_step kernel needs all six tensors on one CUDA device")
    m, w1 = run_d.shape
    w2 = blk_d.shape[1]
    for t, w in zip(args, (w1, w1, w1, w2, w2, w2)):
        expects(t.dim() == 2 and tuple(t.shape) == (m, w)
                and t.is_contiguous(),
                "merge_step kernel takes contiguous (m, w) lists, got %s",
                tuple(t.shape))
    expects(run_d.dtype == blk_d.dtype == torch.float32,
            "merge_step kernel takes float32 distances")
    expects(all(t.dtype == torch.int32
                for t in (run_pos, run_gid, blk_pos, blk_gid)),
            "merge_step kernel takes int32 positions and ids")
    expects(0 < k <= w1 + w2 <= STEP_MAX_W,
            "merge_step kernel: k=%d, w1 + w2 = %d (at most %d)", k,
            w1 + w2, STEP_MAX_W)
    od = torch.empty((m, k), dtype=torch.float32, device=dev)
    op = torch.empty((m, k), dtype=torch.int32, device=dev)
    og = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return od, op, og
    lib = _cuda.library("ring_topk")
    with torch.cuda.device(dev):   # the library sets the card it launches on
        _cuda.check(lib.raft_merge_step(
            run_d.data_ptr(), run_pos.data_ptr(), run_gid.data_ptr(), w1,
            blk_d.data_ptr(), blk_pos.data_ptr(), blk_gid.data_ptr(), w2, m,
            k, int(select_min), od.data_ptr(), op.data_ptr(), og.data_ptr(),
            dev.index, _cuda.stream_of(run_d)), "merge_step")
    merge_step_launches += 1
    return od, op, og


# --------------------------------------------------------------------------
# the ring (engine "ring"; with the plain fold, K8's plain version)
# --------------------------------------------------------------------------

def _ring(ds, gids, k: int, select_min: bool, comms: AxisComms, step):
    """Store-and-forward ring: p−1 ``device_sendrecv`` hops, every shard
    folding the arriving block with ``step`` (position s·k + j for slot j
    of shard s's block). Returns the merged (distances, ids) per shard."""
    p = comms.get_size()
    m = ds[0].shape[0]
    slots = [torch.arange(k, dtype=torch.int32, device=d.device).repeat(m, 1)
             for d in ds]
    state = [(ds[r], r * k + slots[r], gids[r]) for r in range(p)]
    send_d, send_g = list(ds), list(gids)
    for h in range(p - 1):
        recv_d = comms.device_sendrecv(send_d, 1)
        recv_g = comms.device_sendrecv(send_g, 1)
        for r in range(p):
            src = (r - (h + 1)) % p
            state[r] = step(*state[r], recv_d[r], src * k + slots[r],
                            recv_g[r], k, select_min)
        send_d, send_g = recv_d, recv_g
    return [s[0] for s in state], [s[2] for s in state]


def ring_topk_plain(ds, gids, k: int, select_min: bool, mesh: Mesh):
    """Plain version of K8: the ring with the plain fold, on any
    device."""
    return _ring(ds, gids, k, select_min, AxisComms(mesh), merge_step_plain)


# --------------------------------------------------------------------------
# K8: the whole ring in one launch
# --------------------------------------------------------------------------

def _cards(mesh: Mesh) -> dict:
    """Card index → the shards on it, in shard order."""
    cards: dict = {}
    for r, dev in enumerate(mesh.devices):
        cards.setdefault(dev.index, []).append(r)
    return cards


class RingPlan(NamedTuple):
    """K8's launch shape: ``blocks`` ring blocks a shard, each owning
    ``rows`` consecutive rows (the last block may own fewer, none owns
    none), ``steps`` hop steps a block, and the per-shard slot shape."""

    blocks: int
    rows: int
    steps: int
    slot_shape: Tuple[int, int, int]


def ring_plan(m: int, k: int, p: int, shards_per_card: int,
              capacity: int) -> RingPlan:
    """K8's launch shape for p shards' (m, k) lists, at most
    ``shards_per_card`` of them launched together on a card that keeps
    ``capacity`` ring blocks resident: as many blocks a shard as fit and
    have rows, each taking one row range through all p − 1 hops."""
    expects(m >= 1 and k >= 1 and p >= 2, "ring_plan: m=%d, k=%d, p=%d",
            m, k, p)
    blocks = min(capacity // shards_per_card, m)
    expects(blocks >= 1, "ring_topk: no ring block fits the card at k=%d",
            k)
    rows = cdiv(m, blocks)
    return RingPlan(cdiv(m, rows), rows, p - 1, (2, m, k))


_capacity: dict = {}   # (card, k) -> resident ring blocks


def _on_card(card: int, fn):
    """Run a library entry, which sets the card it acts on, with PyTorch's
    current card the same (and restored after)."""
    if card == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(card):
        return fn()


class _Ring:
    """What K8 needs of a (mesh, m, k) besides the call's tensors, worked
    out once: the cards and their shards, whether the ring crosses cards,
    the launch plan, and the pointer tables of the scratch (each shard's
    running cells' positions and its (2, m, k) slots), which is kept for
    the most recent ring on the streams it ran on."""

    scratch_owner = None     # the _Ring whose scratch is allocated

    def __init__(self, lib, mesh: Mesh, m: int, k: int):
        p = mesh.size
        expects(ring_capable(m, k, mesh),
                "ring_topk kernel cannot run k=%d over %s (needs CUDA "
                "shards, 2 <= p <= %d, k <= %d, peer access between "
                "neighbouring cards)", k, mesh, RING_MAX_SHARDS, RING_MAX_K)
        cards = _cards(mesh)
        self.cross = len(cards) > 1
        if self.cross:
            for r in range(p):
                a, b = mesh.devices[r].index, mesh.devices[(r + 1) % p].index
                for x, y in ((a, b), (b, a)):
                    if x != y:
                        _cuda.check(_on_card(
                            x, lambda: lib.raft_ring_enable_peer(x, y)),
                            "peer access")
        for c in cards:
            if (c, k) not in _capacity:
                cap = _on_card(c, lambda: lib.raft_ring_topk_capacity(c, k))
                if cap < 0:
                    _cuda.check(-cap, "ring_topk capacity")
                _capacity[c, k] = cap
        self.plan = min((ring_plan(m, k, p, len(sh), _capacity[c, k])
                         for c, sh in cards.items()),
                        key=lambda pl: pl.blocks)
        self.p, self.m, self.k = p, m, k
        self.cell = m * k * 4                 # bytes of one (m, k) list
        # card, its shards, its device, the shards as a C array, and the
        # words of its flags: (2, blocks) a shard, then the status word
        self.cards = [(c, sh, mesh.devices[sh[0]], (ctypes.c_int * len(sh))(
            *sh), 2 * len(sh) * self.plan.blocks + 1)
            for c, sh in cards.items()]
        self.scratch_key = None

    def _scratch_ptrs(self, streams) -> list:
        """The run_p, slot_d and slot_g pointers of every shard, in that
        order; the scratch is allocated anew when another ring or other
        streams used it last."""
        if _Ring.scratch_owner is not self or self.scratch_key != streams:
            if _Ring.scratch_owner is not None:
                _Ring.scratch_owner.scratch = None
            self.scratch = [torch.empty((len(sh), 5, self.m, self.k),
                                        dtype=torch.int32, device=dev)
                            for _, sh, dev, _, _ in self.cards]
            ptrs = [0] * (3 * self.p)
            for (_, sh, _, _, _), buf in zip(self.cards, self.scratch):
                for j, r in enumerate(sh):
                    base = buf.data_ptr() + 5 * j * self.cell
                    ptrs[r] = base
                    ptrs[self.p + r] = base + self.cell
                    ptrs[2 * self.p + r] = base + 3 * self.cell
            self.scratch_table = ptrs
            self.scratch_key = streams
            _Ring.scratch_owner = self
        return self.scratch_table

    def launch(self, lib, ds, gids, select_min: bool):
        global ring_launches
        p, m, k, cell = self.p, self.m, self.k, self.cell
        blocks = self.plan.blocks
        streams = tuple(torch.cuda.current_stream(c).cuda_stream
                        for c, *_ in self.cards)
        scratch = self._scratch_ptrs(streams)
        out_d, out_g, status = [None] * p, [None] * p, []
        ptr_d, ptr_g, ptr_f = [0] * p, [0] * p, [0] * p
        for c, sh, dev, _, words in self.cards:
            n = len(sh)
            planes = torch.empty((2, n, m, k), dtype=torch.int32, device=dev)
            # (2, blocks) flags a shard, then the status word
            flags = torch.empty(words, dtype=torch.int32, device=dev)
            if self.cross:   # else the library zeroes them
                flags.zero_()
            base, base_f = planes.data_ptr(), flags.data_ptr()
            vd, vg = planes.unbind(0)
            for j, r, d, g in zip(range(n), sh,
                                  vd.view(torch.float32).unbind(0),
                                  vg.unbind(0)):
                out_d[r], out_g[r] = d, g
                ptr_d[r] = base + j * cell
                ptr_g[r] = base + (n + j) * cell
                ptr_f[r] = base_f + j * 2 * blocks * 4
            status.append(flags[-1:])
        if self.cross:
            # no card's ring starts before every card's inputs are written
            # and its flags zeroed: both were queued on that card's current
            # stream, so an event recorded there now covers them; every
            # other card's stream waits on it. The rings' waits then
            # measure the rings alone, not a neighbour's shard search.
            done = {}
            for c, *_ in self.cards:
                done[c] = torch.cuda.Event()
                done[c].record(torch.cuda.current_stream(c))
            for c, *_ in self.cards:
                for c2 in done:
                    if c2 != c:
                        torch.cuda.current_stream(c).wait_event(done[c2])
        # the library's table: per shard in_d, in_g, out_d, out_g, run_p,
        # slot_d, slot_g, flags, each a row of p pointers
        table = (ctypes.c_ulonglong * (8 * p))(
            *[t.data_ptr() for t in ds], *[t.data_ptr() for t in gids],
            *ptr_d, *ptr_g, *scratch, *ptr_f)
        for (c, sh, _, c_sh, _), st, stream in zip(self.cards, status,
                                                   streams):
            _cuda.check(_on_card(c, lambda: lib.raft_ring_topk(
                table, c_sh, len(sh), p, m, k, int(select_min), blocks,
                self.plan.rows, int(self.cross), int(not self.cross), c,
                st.data_ptr(), stream)), "ring_topk")
            ring_launches += 1
        return (out_d, out_g), status


_rings: dict = {}      # (mesh devices, m, k) -> _Ring


def _check_lists(ds, gids, mesh: Mesh, m: int, k: int) -> None:
    """Every shard's lists: contiguous (m, k) float32 / int32 on its own
    CUDA card."""
    shape = (m, k)
    for r, dev in enumerate(mesh.devices):
        d, g = ds[r], gids[r]
        if not (d.dtype is torch.float32 and g.dtype is torch.int32
                and d.shape == shape and g.shape == shape
                and d.get_device() == dev.index == g.get_device()
                and d.is_contiguous() and g.is_contiguous()):
            raise RaftError(
                f"ring_topk kernel: shard {r} takes contiguous ({m}, {k}) "
                f"float32 distances and int32 ids on {dev}, got "
                f"{d.dtype} {tuple(d.shape)} on {d.device} and {g.dtype} "
                f"{tuple(g.shape)} on {g.device}")


def ring_topk_kernel(ds, gids, k: int, select_min: bool, mesh: Mesh):
    """Launch K8 on CUDA shards without waiting for it → ((merged
    distances per shard, merged ids per shard), the status words: one
    int32 per card, set to 1 if a wait of the ring timed out). One
    cooperative launch per card, and one zero-fill of the card's flags and
    status word before it (a memset in the library on one card);
    :func:`ring_topk` reads the status. The
    merged lists of the shards on a card are views of one tensor."""
    p = mesh.size
    m = ds[0].shape[0]
    expects(len(ds) == p and len(gids) == p,
            "ring_topk: %d/%d lists for %d shards", len(ds), len(gids), p)
    _check_lists(ds, gids, mesh, m, k)
    if m == 0:
        return ([torch.empty((0, k), dtype=torch.float32, device=d)
                 for d in mesh.devices],
                [torch.empty((0, k), dtype=torch.int32, device=d)
                 for d in mesh.devices]), []
    lib = _cuda.library("ring_topk")
    key = (tuple(mesh.devices), m, k)
    ring = _rings.get(key)
    if ring is None:
        if len(_rings) >= 64:        # many batch shapes: start over
            _rings.clear()
        ring = _rings[key] = _Ring(lib, mesh, m, k)
    return ring.launch(lib, ds, gids, select_min)


def ring_topk(ds, gids, k: int, select_min: bool, mesh: Mesh):
    """K8 on CUDA shards (raising if its ring timed out), its plain
    version on CPU shards → (merged distances per shard, merged ids per
    shard)."""
    if all(d.type == "cpu" for d in mesh.devices):
        return ring_topk_plain(ds, gids, k, select_min, mesh)
    (out_d, out_g), status = ring_topk_kernel(ds, gids, k, select_min, mesh)
    if any(int(s.item()) for s in status):
        raise RaftError("ring_topk kernel: a ring wait timed out")
    return out_d, out_g


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def merge(ds: Sequence[torch.Tensor], gids: Sequence[torch.Tensor], k: int,
          select_min: bool, mesh: Mesh, engine: str = "allgather"
          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Cross-shard top-k merge of per-shard (m, k) candidates (distances
    and GLOBAL row ids, dead-shard rows already (±inf, -1)), shard r's on
    ``mesh.devices[r]`` → (merged distances, merged int32 ids): one copy
    per shard, on its device, the copies equal. Every engine gives the
    same result (module docstring)."""
    expects(engine in ALL_ENGINES, "unknown sharded merge engine %r", engine)
    if engine == "hier":
        raise RaftError("merge engine 'hier' is not ported yet")
    p = mesh.size
    expects(len(ds) == p and len(gids) == p,
            "merge: %d/%d lists for %d shards", len(ds), len(gids), p)
    m = ds[0].shape[0]
    for d, g in zip(ds, gids):
        expects(tuple(d.shape) == (m, k) and tuple(g.shape) == (m, k),
                "merge takes (m, k) = (%d, %d) lists per shard, got %s / %s",
                m, k, tuple(d.shape), tuple(g.shape))
    if engine == "ring":
        return _ring(ds, gids, k, select_min, AxisComms(mesh), merge_step)
    if engine == "ring_pallas":
        return ring_topk(ds, gids, k, select_min, mesh)
    from ..neighbors import brute_force

    comms = AxisComms(mesh)
    all_d = comms.allgather(ds)
    all_g = comms.allgather(gids)
    outs = [brute_force.knn_merge_parts(a, b, select_min)
            for a, b in zip(all_d, all_g)]
    return [o[0] for o in outs], [o[1] for o in outs]


def ring_capable(m: int, k: int, mesh: Mesh) -> bool:
    """Whether K8 can merge (m, k) lists over ``mesh``'s shards: every
    shard on a CUDA card, 2 <= p <= :data:`RING_MAX_SHARDS`, 1 <= k <=
    :data:`RING_MAX_K`, no more shards on a card than it has SMs (one
    ring block each is always resident), and peer access between
    neighbouring shards on different cards. A ring block takes as many
    rows as the plan gives it, so any m fits."""
    devs = mesh.devices
    p = len(devs)
    if not all(d.type == "cuda" for d in devs) or m < 0:
        return False
    if not (2 <= p <= RING_MAX_SHARDS and 1 <= k <= RING_MAX_K):
        return False
    for card, shards in _cards(mesh).items():
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        if len(shards) > sms:
            return False
    for r in range(p):
        a, b = devs[r].index, devs[(r + 1) % p].index
        if a != b and not (torch.cuda.can_device_access_peer(a, b)
                           and torch.cuda.can_device_access_peer(b, a)):
            return False
    return True


def resolve_engine(m: int, k: int, p: int, override: Optional[str] = None,
                   mesh: Optional[Mesh] = None) -> str:
    """The merge engine of one sharded search call: ``allgather`` for one
    shard; else an explicit ``override`` as given (``"auto"`` asks for the
    default); else the default — ``ring_pallas`` where
    :func:`ring_capable` holds for the search ``mesh`` and all its shards
    share one card, ``allgather`` elsewhere (the CPU included, as in the
    JAX package). K8's cross-card mode has not run on a machine with
    several cards, so only an explicit ``ring_pallas`` reaches it. An
    explicit ``ring_pallas`` is kept where K8 cannot run, so the merge
    raises rather than quietly taking another engine."""
    if p <= 1:
        return "allgather"
    if override is not None:
        eng = str(override).lower()
        expects(eng in ALL_ENGINES + ("auto",),
                "unknown sharded merge engine %r (one of %s)", eng,
                ALL_ENGINES + ("auto",))
        if eng != "auto":
            return eng
    if (mesh is not None and len(_cards(mesh)) == 1
            and ring_capable(m, k, mesh)):
        return "ring_pallas"
    return "allgather"


# family -> merge engine that served the most recent sharded search in
# this process
active_engines: dict = {}


def note_engine(family: str, engine: str) -> None:
    active_engines[family] = engine
