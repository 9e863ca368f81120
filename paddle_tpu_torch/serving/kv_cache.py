"""Paged KV cache and the single-token GPT decode step (the port of
``paddle_tpu/serving/kv_cache.py``).

Generating through the bucketized batch server would re-attend the whole
prefix with a fresh full-context run for every token (O(T²) a token), and
every length would be a new shape.  The decode engine instead keeps
per-layer K/V pools of FIXED-SIZE pages (``[L, n_pages, page_len, H, Dh]``),
gives each in-flight request a slot with a page list (grown a page at a
time, freed on completion), and runs ONE step over the fixed ``[slots]``
batch: requests join and leave between iterations by flipping their slot's
active flag.  Page 0 is reserved scratch that inactive slots write into, so
the scatter's shape never changes.

On the card the step is captured once into a ``torch.cuda.CUDAGraph`` (the
port's analog of the reference's one ``jax.jit`` trace): its inputs are
static device buffers that each call overwrites before it replays the
graph, and the pools are written in place, which is what the reference's
donation does on the TPU.  The graph holds the pools' addresses, so they are
never reallocated: ``reinit_pools`` zeroes them in place.  On the host the
same step runs eagerly.

The step mirrors the reference's ``_step_impl`` op by op (arange positions,
the pre-encoder LayerNorm, fused-QKV post-LN blocks, erf-gelu FFN, float32
LayerNorm and softmax statistics, attention over the slot's whole page
window with positions past ``pos`` masked), so its logits match the
full-context serving program's.  It runs no hand-written kernel: the
reference's attention here is plain einsum too.

Each cache registers its pools with the HBM accountant
(``hbm.register_kv_pool``), which attributes their bytes to the
``kv_pages`` class.  Not ported yet (ROADMAP): the sharding gate of
``DecodeEngine(program=...)`` (``analysis/sharding.py``
``check_decode_hostable``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import monitor as _monitor

KV_PAGES_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_serving_kv_pages_in_use",
    "KV-cache pages currently owned by in-flight decode requests "
    "(page 0, the inactive-slot scratch page, is never owned)")
KV_ALLOC_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_serving_kv_page_events_total",
    "KV page pool events", ("event",))
_ALLOC = KV_ALLOC_CTR.labels(event="alloc")
_FREE = KV_ALLOC_CTR.labels(event="free")
_EXHAUSTED = KV_ALLOC_CTR.labels(event="exhausted")


class PagedKVCache:
    """Fixed-size page pool for one decode engine.

    Host side: a free-page list and per-slot page lists (``alloc_page`` /
    ``free_slot``).  Device side: the stacked K/V pools the step writes in
    place.  Page 0 is reserved scratch — inactive slots' writes land there,
    so the step's scatter indices never change shape.
    """

    def __init__(self, n_layers: int, n_pages: int, page_len: int,
                 n_head: int, d_head: int, max_slots: int,
                 dtype=torch.float32, device="cpu"):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self.n_layers = int(n_layers)
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        self.max_slots = int(max_slots)
        shape = (n_layers, n_pages, page_len, n_head, d_head)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._mu = threading.Lock()
        self._free: List[int] = list(range(1, n_pages))  # guarded-by: _mu
        self._owned: Dict[int, List[int]] = {}  # guarded-by: _mu
        # the pools' bytes are the accountant's kv_pages class (weakly
        # registered: telemetry never keeps a dead engine's pools alive)
        from .. import hbm as _hbm
        _hbm.register_kv_pool(self)

    def alloc_page(self, slot: int) -> Optional[int]:
        """Grant ``slot`` one more page; None when the pool is exhausted
        (the caller parks the request until a completion frees pages)."""
        with self._mu:
            if not self._free:
                _EXHAUSTED.inc()
                return None
            page = self._free.pop()
            self._owned.setdefault(slot, []).append(page)
            in_use = self.n_pages - 1 - len(self._free)
        _ALLOC.inc()
        KV_PAGES_GAUGE.set(in_use)
        return page

    def free_slot(self, slot: int) -> int:
        """Return every page ``slot`` owns to the pool (request complete);
        returns how many were freed.  The page CONTENTS are not cleared —
        the next owner overwrites positions before attending them, and the
        attention mask hides everything past the written prefix."""
        with self._mu:
            pages = self._owned.pop(slot, [])
            self._free.extend(pages)
            in_use = self.n_pages - 1 - len(self._free)
        if pages:
            _FREE.inc(len(pages))
            KV_PAGES_GAUGE.set(in_use)
        return len(pages)

    def pages_in_use(self) -> int:
        with self._mu:
            return self.n_pages - 1 - len(self._free)

    def buffers_alive(self) -> bool:
        """Whether the pools survived a failed step.  The reference donates
        them to each step, and a step that dies mid-execution consumes
        them; the port writes them in place, so they outlive any failed
        step (a failed step's partial writes sit at positions the retry
        writes again before it attends them)."""
        return True

    def reinit_pools(self) -> None:
        """Zero the pools IN PLACE (a captured step holds their addresses,
        so they are never reallocated).  Cached prefixes are gone, so the
        caller fails every in-flight request first; page bookkeeping stays
        valid."""
        self.k.zero_()
        self.v.zero_()

    def pages_of(self, slot: int) -> List[int]:
        with self._mu:
            return list(self._owned.get(slot, []))

    def pool_bytes(self) -> int:
        """Device bytes of the K/V pools (both stacks) — the resident cost
        of the cache regardless of page occupancy."""
        return sum(t.numel() * t.element_size() for t in (self.k, self.v))


#: the GPT parameter names of ``models.transformer.build_gpt_pretrain``
_GLOBAL_PARAMS = ("word_embedding", "pos_embedding", "pre_encoder.ln.w",
                  "pre_encoder.ln.b", "lm_out.w", "lm_out.b")
_LAYER_PARAMS = ("attn.qkv.w", "attn.qkv.b", "attn.out.w", "attn.out.b",
                 "ln1.w", "ln1.b", "ffn.fc1.w", "ffn.fc1.b", "ffn.fc2.w",
                 "ffn.fc2.b", "ln2.w", "ln2.b")


def params_from_scope(scope, cfg, device=None) -> Dict[str, torch.Tensor]:
    """Pull the GPT parameter set (models/transformer naming) out of a
    scope holding an initialized ``build_gpt_pretrain`` (or
    ``build_gpt_serving``) model, onto ``device`` (None: where they lie)."""
    names = list(_GLOBAL_PARAMS) + [f"enc_{i}.{n}" for i in range(cfg.n_layer)
                                    for n in _LAYER_PARAMS]
    params = {}
    for n in names:
        v = scope.find_var(n)
        if v is None:
            raise KeyError(
                f"GPT decode param {n!r} missing from scope — build the "
                "model with models.transformer.build_gpt_pretrain and run "
                "the startup program first")
        params[n] = torch.as_tensor(v).to(device) if device is not None \
            else torch.as_tensor(v)
    return params


def _layer_norm(x, w, b, eps=1e-5):
    # mirrors ops/nn_ops._layer_norm: stats in float32, affine in x's dtype
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps)
    y = (x - m.to(x.dtype)) * inv.to(x.dtype)
    return (y * w.to(y.dtype) + b.to(y.dtype)).to(x.dtype)


def _long(x, device):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.long, device=device)


class GPTDecodeModel:
    """One-token-per-slot decode step over the paged cache, built once.

    ``step(params, k, v, ids, pos, page_table, active)`` processes the
    current token of every slot: writes this position's K/V into the slot's
    page, attends the slot's whole cached window (pages gathered by the
    table, positions past ``pos`` masked), and returns the next-token
    logits.  All shapes are fixed by (slots, max_pages, page_len).  On the
    card the first call captures the step into a CUDA graph and every later
    call — whatever mix of requests occupies the slots — replays it; on the
    host the first call builds nothing but is counted the same way, so
    ``trace_count`` is 1 for the life of a model either way (asserted in
    tests).  :meth:`step_eager` is the uncaptured step.
    """

    def __init__(self, cfg, page_len: int, max_pages: int):
        self.cfg = cfg
        self.page_len = int(page_len)
        self.max_pages = int(max_pages)
        self.n_head = cfg.n_head
        self.d_head = cfg.d_model // cfg.n_head
        self.trace_count = 0
        self._graph = None
        self._static: Dict[str, torch.Tensor] = {}
        self._bound = None      # (params, k, v) the captured graph reads

    def kv_shape(self, n_pages: int):
        return (self.cfg.n_layer, n_pages, self.page_len, self.n_head,
                self.d_head)

    def step(self, params, k, v, ids, pos, page_table, active):
        """ids/pos/active: [S] integers/bools; page_table: [S, max_pages]
        integers (unallocated entries 0 — masked off by ``pos``), host
        arrays or tensors.  Writes this position's K/V into ``k``/``v`` in
        place and returns the logits [S, vocab] on the pools' device — on
        the card the graph's static output, which the next call
        overwrites."""
        dev = k.device
        if dev.type != "cuda":
            if self.trace_count == 0:
                self.trace_count = 1
            return self.step_eager(
                params, k, v, _long(ids, dev), _long(pos, dev),
                _long(page_table, dev),
                torch.as_tensor(np.asarray(active), dtype=torch.bool))
        with torch.cuda.device(dev):
            if self._graph is None:
                self._capture(params, k, v, len(ids))
            elif self._bound != (id(params), k.data_ptr(), v.data_ptr()):
                raise RuntimeError(
                    "GPTDecodeModel: the captured step reads other params "
                    "or pools than these; a model serves one engine")
            st = self._static
            for name, x in (("ids", ids), ("pos", pos),
                            ("page_table", page_table), ("active", active)):
                src = x if isinstance(x, torch.Tensor) else \
                    torch.from_numpy(np.ascontiguousarray(x))
                if tuple(src.shape) != tuple(st[name].shape):
                    raise ValueError(
                        f"GPTDecodeModel.step: {name} has shape "
                        f"{tuple(src.shape)}, the captured step "
                        f"{tuple(st[name].shape)}")
                st[name].copy_(src)
            self._graph.replay()
            return st["logits"]

    def _capture(self, params, k, v, n_slots: int) -> None:
        """Capture the step into one CUDA graph over static input buffers.
        A warm-up on a side stream first (PyTorch's CUDA-graph recipe:
        library handles and workspaces are made outside the capture); with
        every slot inactive it writes scratch page 0 only.  A capture that
        fails raises: nothing falls back to running the step eagerly."""
        dev = k.device
        st = {"ids": torch.zeros(n_slots, dtype=torch.long, device=dev),
              "pos": torch.zeros(n_slots, dtype=torch.long, device=dev),
              "page_table": torch.zeros(n_slots, self.max_pages,
                                        dtype=torch.long, device=dev),
              "active": torch.zeros(n_slots, dtype=torch.bool, device=dev)}
        args = (st["ids"], st["pos"], st["page_table"], st["active"])
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step_eager(params, k, v, *args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's work on the card (a batch server
        # in the same process) does not invalidate this capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            st["logits"] = self.step_eager(params, k, v, *args)
        self._graph, self._static = graph, st
        self._bound = (id(params), k.data_ptr(), v.data_ptr())
        self.trace_count += 1

    def step_eager(self, params, k, v, ids, pos, page_table, active):
        """The uncaptured step on tensors of the pools' device (ids, pos,
        page_table int64; active bool).  No host sync inside (no ``.item()``,
        boolean-mask indexing or ``nonzero``), so it captures."""
        cfg = self.cfg
        S = ids.shape[0]
        H, Dh, D = self.n_head, self.d_head, cfg.d_model
        PL, MP = self.page_len, self.max_pages
        T = MP * PL                      # max attended context per slot
        scale = float(Dh) ** -0.5

        x = params["word_embedding"][ids] + params["pos_embedding"][pos]
        x = _layer_norm(x, params["pre_encoder.ln.w"],
                        params["pre_encoder.ln.b"])

        # this token's write target: (page, offset) per slot; inactive
        # slots are routed to scratch page 0 so the scatter stays dense
        page_idx = torch.div(pos, PL, rounding_mode="floor")
        offset = pos - page_idx * PL
        cur_page = torch.take_along_dim(page_table, page_idx[:, None],
                                        dim=1)[:, 0]
        cur_page = torch.where(active, cur_page, torch.zeros_like(cur_page))

        # context mask: position t of the gathered pages is attendable iff
        # t <= pos (page-table order IS position order)
        t_idx = torch.arange(T, device=pos.device)
        hidden = (t_idx[None, :] > pos[:, None])[:, None, :]   # [S, 1, T]

        for i in range(cfg.n_layer):
            p = f"enc_{i}"
            qkv = x @ params[f"{p}.attn.qkv.w"] + params[f"{p}.attn.qkv.b"]
            q, k_new, v_new = qkv.split(D, dim=-1)
            q = q.reshape(S, H, Dh)
            k[i].index_put_((cur_page, offset), k_new.reshape(S, H, Dh))
            v[i].index_put_((cur_page, offset), v_new.reshape(S, H, Dh))
            # gather this slot's window: [S, MP, PL, H, Dh] -> [S, T, H, Dh]
            kp = k[i][page_table].reshape(S, T, H, Dh)
            vp = v[i][page_table].reshape(S, T, H, Dh)
            scores = torch.einsum("shd,sthd->sht", q, kp) * scale
            scores = scores.masked_fill(hidden, -1e9)
            w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            ctx = torch.einsum("sht,sthd->shd", w, vp).reshape(S, D)
            attn = ctx @ params[f"{p}.attn.out.w"] + \
                params[f"{p}.attn.out.b"]
            x = _layer_norm(x + attn, params[f"{p}.ln1.w"],
                            params[f"{p}.ln1.b"])
            h = x @ params[f"{p}.ffn.fc1.w"] + params[f"{p}.ffn.fc1.b"]
            h = F.gelu(h)
            ffn = h @ params[f"{p}.ffn.fc2.w"] + params[f"{p}.ffn.fc2.b"]
            x = _layer_norm(x + ffn, params[f"{p}.ln2.w"],
                            params[f"{p}.ln2.b"])

        return x @ params["lm_out.w"] + params["lm_out.b"]


def _to_device(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    from ..io import _to_tensor
    return _to_tensor(np.asarray(a), None, device)


class DecodeEngine:
    """Ties the model step to the page pool for the decode scheduler.

    Holds the device pools, the host page tables, and the parameters on
    ``place``'s device (``CUDAPlace(0)`` by default: without a GPU the
    engine raises, as ``Executor()`` does; ask for ``CPUPlace()`` to run on
    the host).  The scheduler drives :meth:`run_iteration` with whatever
    requests currently occupy slots.  Greedy (argmax) decoding.
    ``params_or_scope`` is a scope holding the GPT's parameters, or a dict
    of numpy arrays or tensors under the same names.
    """

    def __init__(self, cfg, params_or_scope, max_slots: int = 4,
                 page_len: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 program=None, place=None):
        from ..flags import get_flags
        from ..place import checked_device
        if program is not None:
            raise NotImplementedError(
                "DecodeEngine(program=...): the decode-hostability gate "
                "(analysis/sharding.py check_decode_hostable) is not ported")
        self.device = checked_device(place, "DecodeEngine")
        fl = get_flags(["FLAGS_serving_kv_page_len",
                        "FLAGS_serving_kv_pages"])
        self.cfg = cfg
        self.page_len = int(page_len or fl["FLAGS_serving_kv_page_len"])
        self.max_seq = int(max_seq or cfg.max_pos)
        self.max_pages = -(-self.max_seq // self.page_len)  # ceil div
        self.max_slots = int(max_slots)
        n_pages = int(n_pages or fl["FLAGS_serving_kv_pages"]) or \
            (1 + self.max_slots * self.max_pages)
        if hasattr(params_or_scope, "find_var"):
            self.params = params_from_scope(params_or_scope, cfg,
                                            self.device)
        else:
            self.params = {n: _to_device(a, self.device)
                           for n, a in dict(params_or_scope).items()}
        self.model = GPTDecodeModel(cfg, self.page_len, self.max_pages)
        self.cache = PagedKVCache(
            cfg.n_layer, n_pages, self.page_len, cfg.n_head,
            cfg.d_model // cfg.n_head, self.max_slots, device=self.device)
        # host-side page table mirror fed to every step
        self.page_table = np.zeros((self.max_slots, self.max_pages),
                                   np.int32)

    @property
    def trace_count(self) -> int:
        return self.model.trace_count

    def reserve_slot(self, slot: int, n_pages: int) -> bool:
        """Allocate a request's WORST-CASE page count up front (rolled back
        on shortfall).  Admission-time reservation is what makes the decode
        loop deadlock-free: two optimistically-admitted requests could
        otherwise each stall on the other's unreleased pages mid-growth —
        and completions happen on the same thread that would be stalling,
        so nothing would ever free them."""
        if n_pages > self.max_pages:
            return False
        got = []
        for _ in range(n_pages):
            p = self.cache.alloc_page(slot)
            if p is None:
                self.cache.free_slot(slot)   # roll back the partial grab
                self.page_table[slot, :] = 0
                return False
            got.append(p)
        for i, p in enumerate(got):
            self.page_table[slot, i] = p
        return True

    def ensure_page(self, slot: int, pos: int) -> bool:
        """Make sure the page covering ``pos`` exists for ``slot``; False
        when the pool is exhausted (the caller defers the request)."""
        need = pos // self.page_len
        if need >= self.max_pages:
            return False         # past the engine's max context window
        owned = len(self.cache.pages_of(slot))
        while owned <= need:
            page = self.cache.alloc_page(slot)
            if page is None:
                return False
            self.page_table[slot, owned] = page
            owned += 1
        return True

    def release_slot(self, slot: int) -> None:
        self.cache.free_slot(slot)
        self.page_table[slot, :] = 0

    def run_iteration(self, ids, pos, active):
        """One decode step over all slots; returns the logits [S, vocab] as
        host numpy, after writing this position's K/V into the pools."""
        logits = self.model.step(self.params, self.cache.k, self.cache.v,
                                 ids, pos, self.page_table, active)
        return logits.cpu().numpy()
