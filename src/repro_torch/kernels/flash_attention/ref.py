"""Plain PyTorch versions of the flash-attention kernels: the forward (the
whole score matrix, masked, through one f32 softmax) and the backward
(the reference's flash backward, key block by key block), with the
tolerances a bf16 kernel is held to against them."""
from __future__ import annotations

import torch

NEG_INF = -1e30
#: unit roundoff of bfloat16 (8 significant bits)
BF16_U = 2.0 ** -8
#: keys a block of :func:`attention_bwd_ref` recomputes at once
BWD_KEY_BLOCK = 512
#: f32 sums in other orders over up to 2,048 keys: a gradient's floor in
#: :func:`bwd_bf16_tolerance`, of its largest magnitude (chip_smoke's f32
#: ``BWD_TOL``)
BWD_F32_TOL = 5e-5


def _scores(q, k, *, causal, window, scale, valid_len):
    """Scaled f32 scores [B,Hkv,G,Sq,Sk], masked to -1e30, and the [Sq]
    rows that have at least one unmasked column."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    valid_len = valid_len or sk
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    ok = col < valid_len
    if causal:
        ok = ok & (col <= row)
    if window:
        ok = ok & ((row - col) < window)
    return torch.where(ok, s, NEG_INF), ok.any(dim=-1)[:, None]


def _probs(q, k, *, causal, window, scale, valid_len):
    """Normalised f32 probabilities [B,Hkv,G,Sq,Sk] and the [Sq] rows that
    have at least one unmasked column."""
    s, live = _scores(q, k, causal=causal, window=window, scale=scale,
                      valid_len=valid_len)
    return torch.softmax(s, dim=-1), live


def _apply(p, v, live, hq):
    b, hkv, _, sq, _ = p.shape
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return torch.where(live, out, 0.0).reshape(b, hq, sq, v.shape[-1])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, scale=None,
                  valid_len: int = 0, return_lse: bool = False):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] → [B,Hq,Sq,D] in q's dtype.

    Masks ``col < valid_len`` (0 means Sk), ``col <= row`` when causal and
    ``row - col < window`` when ``window > 0``; a row with no unmasked
    column gives 0.  Kv head of query head h is ``h // (Hq // Hkv)``.

    With ``return_lse`` also each row's log-sum-exp of its scaled scores,
    f32 [B,Hq,Sq], in natural-log units: ``m + log(l)``, the reference's
    ``lse`` (``repro/models/attention.py:136``); a row with no unmasked
    column gives -1e30, as there (all its scores are -1e30).
    """
    s, live = _scores(q, k, causal=causal, window=window, scale=scale,
                      valid_len=valid_len)
    out = _apply(torch.softmax(s, dim=-1), v.float(), live,
                 q.shape[1]).to(q.dtype)
    if not return_lse:
        return out
    b, hq, sq, _ = q.shape
    return out, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, scale=None,
                   valid_len: int = 0, sigmas: float = 8.0):
    """For bf16 q, k, v [B,H,S,D] as in :func:`attention_ref`: the f32
    attention ``want`` of these values and a per-element limit ``tol`` on
    the distance of a bf16 kernel's output from it, both f32 [B,Hq,Sq,D].

    A kernel that accumulates in f32 but rounds P to bf16 before P·V and
    rounds its output to bf16 lies within the sum of:
    - 2e-5: f32 sums in another order (the f32 check's limit);
    - ``u·|want|``: the output's rounding, ``u`` = 2^-8;
    - P's rounding, each p off by at most ``u·p``: the smaller of the worst
      case ``u·Σp|v|`` and the Hoeffding limit ``sigmas·u·sqrt(Σp²v²)``,
      which independent roundings pass with probability
      ``2·exp(-sigmas²/2)`` per element (3e-14 at 8).
    p is normalised.  A key wrongly taken in or left out moves a row by
    ``p·|v - want|``, about ``|v|/n`` for n live keys of similar score,
    while the rounding terms shrink like ``1/sqrt(n)``, so a mask that is
    off by one exceeds ``tol`` for long rows."""
    p, live = _probs(q, k, causal=causal, window=window, scale=scale,
                     valid_len=valid_len)
    hq, vf = q.shape[1], v.float()
    want = _apply(p, vf, live, hq)
    worst = _apply(p, vf.abs(), live, hq)
    spread = _apply(p.square(), vf.square(), live, hq).sqrt()
    del p
    tol = 2e-5 + BF16_U * (want.abs() + torch.minimum(worst,
                                                       sigmas * spread))
    return want, tol


def _group(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D]."""
    b, s, hq, d = x.shape
    return x.reshape(b, s, n_kv, hq // n_kv, d)


def _bwd_blocks(q, k, v, out, lse, do, *, causal, window, scale, valid_len):
    """The backward's recomputation, key block by key block: (q and do
    grouped in f32 [B,Sq,Hkv,G,*], then per block of ``BWD_KEY_BLOCK``
    keys (k0, k1, k and v of the block in f32, p and ds f32
    [B,Hkv,G,Sq,k1-k0])).  ``p = exp(s - lse)`` where the forward's masks
    leave (row, col) live, else 0; ``ds = p (dp - delta) scale`` with
    ``dp = do·vᵀ`` and ``delta = rowsum(out * do)``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    live_k = min(sk, valid_len or sk)
    qg = _group(q, hkv).float()                          # [B,Sq,Hkv,G,D]
    dog = _group(do, hkv).float()                        # [B,Sq,Hkv,G,Dv]
    delta = (_group(out, hkv).float() * dog).sum(-1)     # [B,Sq,Hkv,G]
    delta = delta.permute(0, 2, 3, 1)[..., None]         # [B,Hkv,G,Sq,1]
    lse = lse.reshape(b, hkv, g, sq, 1)
    pos_q = torch.arange(sq, device=q.device)[:, None]

    def blocks():
        for k0 in range(0, sk, BWD_KEY_BLOCK):
            k1 = min(k0 + BWD_KEY_BLOCK, sk)
            kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
            pos_k = torch.arange(k0, k1, device=q.device)[None, :]
            ok = pos_k < live_k
            if causal:
                ok = ok & (pos_k <= pos_q)
            if window:
                ok = ok & ((pos_q - pos_k) < window)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
            p = torch.where(ok, torch.exp(s - lse), 0.0)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vb)
            yield k0, k1, kb, vb, p, p * (dp - delta) * scale

    return qg, dog, blocks()


def attention_bwd_ref(q, k, v, out, lse, do, *, causal=True, window=0,
                      scale=None, valid_len=0, rounding=None):
    """The reference's ``_flash_bwd`` in plain torch: (dq, dk, dv) in the
    dtypes of q, k, v from the saved q [B,Sq,Hq,D], k [B,Sk,Hkv,D], v
    [B,Sk,Hkv,Dv], ``out`` [B,Sq,Hq,Dv], ``lse`` [B,Hq,Sq] and the
    output's cotangent ``do``, in the model layout.

    Key blocks of ``BWD_KEY_BLOCK`` columns, each recomputing its
    probabilities ``p = exp(s - lse)`` in f32, masked as the forward masks
    them (keys at or past ``valid_len``, 0 meaning Sk, causal, window): the
    memory is O(Sq · BWD_KEY_BLOCK) per head, never O(Sq · Sk).  A row with
    no live key has p = 0 in every column, so no gradient, consistent with
    its output of 0 (the reference's padded rows carry a cotangent of 0).
    v may be narrower than q/k (MLA's Dv 128 beside D 192); ``scale``
    defaults to D ** -0.5 over q/k's head dim.

    ``rounding`` (a dtype, e.g. bfloat16) emulates the tensor-core kernel:
    p and ds rounded to it as the operands of their products (ds formed
    from the f32 p), every sum still f32.  Default None: all f32."""
    qg, dog, blocks = _bwd_blocks(q, k, v, out, lse, do, causal=causal,
                                  window=window, scale=scale,
                                  valid_len=valid_len)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for k0, k1, kb, _, p, ds in blocks:
        if rounding is not None:
            p, ds = p.to(rounding).float(), ds.to(rounding).float()
        dv[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
        dk[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_bf16_tolerance(q, k, v, out, lse, do, *, causal=True, window=0,
                       scale=None, valid_len=0, sigmas: float = 8.0):
    """For bf16 (or f32) q, k, v, out, lse and do as in
    :func:`attention_bwd_ref`: the f32 gradients ``want`` = (dq, dk, dv)
    of these values (the plain backward before its final rounding) and a
    per-element limit ``tol`` on the distance of a bf16 kernel's gradients
    from them, both f32 in the shapes of q, k and v.

    A kernel that rounds p and ds to bf16 as the operands of dv = pᵀ·do,
    dk = dsᵀ·q and dq = ds·k, sums in f32 and rounds its outputs to bf16
    lies within the sum of:
    - ``BWD_F32_TOL`` of the gradient's largest magnitude: f32 sums in
      other orders (scores, dp, delta), exp2 for exp;
    - ``u·|want|``: the output's rounding, ``u`` = 2^-8;
    - p's (ds's) rounding, each off by at most ``u·p``: the smaller of the
      worst case ``u·Σ p|x|`` and the Hoeffding limit
      ``sigmas·u·sqrt(Σ p²x²)`` over the other operand x (do for dv, q for
      dk, k for dq), which independent roundings pass with probability
      ``2·exp(-sigmas²/2)`` per element (3e-14 at 8).
    A dropped mask, delta left out or a wrong scale moves a gradient by a
    fraction of its own size, far past these terms."""
    qg, dog, blocks = _bwd_blocks(q, k, v, out, lse, do, causal=causal,
                                  window=window, scale=scale,
                                  valid_len=valid_len)
    f32 = dict(dtype=torch.float32, device=q.device)
    want = [torch.zeros(qg.shape, **f32), torch.zeros(k.shape, **f32),
            torch.zeros(v.shape, **f32)]
    worst = [torch.zeros_like(w) for w in want]
    spread = [torch.zeros_like(w) for w in want]
    qa, doa = qg.abs(), dog.abs()
    for k0, k1, kb, _, p, ds in blocks:
        pa, dsa, ka = p.abs(), ds.abs(), kb.abs()
        for i, (m, ma, x, xa, spec) in enumerate((
                (ds, dsa, kb, ka, "bhgqk,bkhd->bqhgd"),
                (ds, dsa, qg, qa, "bhgqk,bqhgd->bkhd"),
                (p, pa, dog, doa, "bhgqk,bqhgd->bkhd"))):
            sl = slice(None) if i == 0 else slice(k0, k1)
            want[i][:, sl] += torch.einsum(spec, m, x)
            worst[i][:, sl] += torch.einsum(spec, ma, xa)
            spread[i][:, sl] += torch.einsum(spec, m.square(), x.square())
    out_ = []
    for w, wc, sp, like in zip(want, worst, spread, (q, k, v)):
        w, wc, sp = (t.reshape(like.shape) for t in (w, wc, sp))
        floor = BWD_F32_TOL * w.abs().max()
        out_.append((w, floor + BF16_U * (w.abs() + torch.minimum(
            wc, sigmas * sp.sqrt()))))
    return tuple(w for w, _ in out_), tuple(t for _, t in out_)
