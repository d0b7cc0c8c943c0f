"""Plain PyTorch versions of the port's kernels (the allclose references).

Each repeats its kernel's arithmetic with ordinary tensor operations and
runs on whatever device its inputs lie on.  The CPU tests use them, the
``torch`` conv backend runs them, and ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.  They are references, not
yardsticks of speed.  ``ssd_ref``, the sequential recurrence, is the
tests' oracle and no kernel's plain version.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def ieee_fp32_matmul(device: torch.device):
    """Matmuls on the card in IEEE float32 for the duration, with the
    process-wide TF32 flag restored after.  The flag is global, so the
    callers that flip it take turns (two threads never interleave a save
    and a restore), and a caller may nest it."""
    if device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float32 accumulation, float64 for float64 inputs."""
    acc_t = torch.float32
    for t in ts:
        acc_t = torch.promote_types(acc_t, t.dtype)
    return acc_t


def _direct_conv(xp: torch.Tensor, w: torch.Tensor, h: int, wd: int) -> torch.Tensor:
    """The Pallas driver's arithmetic (repro/kernels/conv2d.py,
    ``_direct_conv`` / ``_conv2d_kernel``): a pre-padded input xp
    (B, h+kh-1, wd+kw-1, Cin) against w (kh, kw, Cin, Cout), one matmul
    per tap (i, j), accumulated.  Returns (B, h, wd, Cout) in the
    accumulation dtype."""
    kh, kw, cin, cout = w.shape
    b = xp.shape[0]
    acc_t = _acc_dtype(xp, w)
    xp, wa = xp.to(acc_t), w.to(acc_t)
    acc = torch.zeros((b * h * wd, cout), dtype=acc_t, device=xp.device)
    with ieee_fp32_matmul(xp.device):
        for i in range(kh):
            for j in range(kw):
                xs = xp[:, i : i + h, j : j + wd, :].reshape(b * h * wd, cin)
                acc = acc + xs @ wa[i, j]
    return acc.reshape(b, h, wd, cout)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, SAME padding, stride 1, in x's dtype.

    Repeats the Pallas kernel's arithmetic (repro/kernels/conv2d.py,
    ``conv2d_pallas``): explicit pad ``(k//2, k-1-k//2)`` on both
    spatial axes, then one matmul per tap (i, j), accumulated.  The
    accumulation runs in float32 (float64 inputs stay float64).  On the
    card TF32 is switched off for these matmuls and restored after, so
    float32 means IEEE float32 there too."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    if b * h * wd * cout == 0:
        return torch.zeros((b, h, wd, cout), dtype=x.dtype, device=x.device)
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    return _direct_conv(xp, w, h, wd).to(x.dtype)


def conv2d_dx_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of the SAME stride-1 conv, in g's dtype: g (B, H, W, Cout)
    against the forward kernel w (kh, kw, Cin, Cout) -> (B, H, W, Cin).

    Repeats ``conv2d_dx_pallas``: the forward tap loop run on g against
    the spatially flipped, channel-swapped kernel, under the complementary
    pad ``(kh-1-kh//2, kh//2)`` (the forward's, for odd kernels)."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = g.shape
    if b * h * wd * cin == 0 or cout == 0:
        return torch.zeros((b, h, wd, cin), dtype=g.dtype, device=g.device)
    ph, pw = kh // 2, kw // 2
    wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)  # (kh, kw, Cout, Cin)
    gp = F.pad(g, (0, 0, kw - 1 - pw, pw, kh - 1 - ph, ph))
    return _direct_conv(gp, wt, h, wd).to(g.dtype)


def conv2d_dw_ref(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """dW of the SAME stride-1 conv: x (B, H, W, Cin) and g (B, H, W,
    Cout) -> (kh, kw, Cin, Cout) in float32 (float64 for float64 inputs).

    Repeats ``conv2d_dw_pallas``: per tap (i, j), one ``xs^T @ g``
    contracting the pixels of the shifted window of the SAME-padded x
    against g, accumulated in float32.  No pixels (B*H*W = 0) give a
    zero dW."""
    b, h, wd, cin = x.shape
    cout = g.shape[-1]
    acc_t = _acc_dtype(x, g)
    dw = torch.zeros((kh, kw, cin, cout), dtype=acc_t, device=x.device)
    if b * h * wd * cin * cout == 0:
        return dw
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x.to(acc_t), (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    gs = g.to(acc_t).reshape(b * h * wd, cout)
    with ieee_fp32_matmul(x.device):
        for i in range(kh):
            for j in range(kw):
                xs = xp[:, i : i + h, j : j + wd, :].reshape(b * h * wd, cin)
                dw[i, j] = xs.T @ gs
    return dw


def attention_mask(s: int, t: int, causal: bool, window, device) -> torch.Tensor:
    """(S, T) bool, True where query i (at position T - S + i) may see
    key j under the causal and window masks."""
    q_pos = torch.arange(s, device=device)[:, None] + (t - s)
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    return mask


def check_lengths(s: int, t: int, causal: bool, window) -> None:
    """Raise unless S queries may attend T keys under the flash contract:
    both at least 1, and T >= S wherever a mask reads the queries'
    right-aligned positions (causal, or a window)."""
    if s == 0 or t == 0 or (t < s and (causal or window is not None)):
        raise ValueError(f"flash_attention: want T >= S >= 1 (or S, T >= 1 with "
                         f"neither a causal mask nor a window), got S={s}, T={t}, "
                         f"causal={causal}, window={window}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None) -> torch.Tensor:
    """Attention with the Pallas kernel's contract, in q's dtype.

    q: (B, H, S, D); k, v: (B, KV, T, D) with T >= S (or any S and T
    with neither a causal mask nor a window) and KV dividing H
    (query head h reads kv head h // (H/KV), the head order of the JAX
    package's ``_split_gqa``).  Queries are right-aligned against the
    keys (query i sits at position T - S + i); the causal and window
    masks apply to those absolute positions.  Scores, softmax and the
    weighted sum run in float32 (float64 stays float64) with masked
    scores at -1e30, as ``repro/kernels/ref.py::flash_attention_ref``."""
    check_lengths(q.shape[2], k.shape[2], causal, window)
    acc_t = _acc_dtype(q, k, v)
    group = q.shape[1] // k.shape[1]
    kf = k.to(acc_t).repeat_interleave(group, dim=1)
    vf = v.to(acc_t).repeat_interleave(group, dim=1)
    scale = q.shape[-1] ** -0.5
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    with ieee_fp32_matmul(q.device):
        s = (q.to(acc_t) @ kf.transpose(-1, -2)) * scale
        s = s.masked_fill(~mask, -1e30)
        out = torch.softmax(s, dim=-1) @ vf
    return out.to(q.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, chunk: int):
    """Chunked SSD scan (mamba-2), a copy of the JAX package's
    ``repro/layers/mamba2.py::_ssd_chunked``.

    x: (B, S, H, P); dt: (B, S, H), already softplus'd; a: (H,),
    negative; bmat, cmat: (B, S, G, N) with G dividing H (head h reads
    group h // (H/G)).  Returns (y (B, S, H, P) in x's dtype, the final
    state (B, H, P, N) in float32; float64 inputs stay float64)."""
    acc_t, out_t = _acc_dtype(x, bmat, cmat), x.dtype
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    x, dt, a = x.to(acc_t), dt.to(acc_t), a.to(acc_t)
    bmat, cmat = bmat.to(acc_t), cmat.to(acc_t)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bh = bmat.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)
    ch = cmat.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)

    cum = torch.cumsum(dtc * a, dim=2)  # (B,nc,L,H) inclusive log-decay
    total = cum[:, :, -1, :]  # (B,nc,H)
    with ieee_fp32_matmul(x.device):
        # intra-chunk: y[t] = sum_{u<=t} C_t.B_u exp(cum_t - cum_u) dt_u x_u
        scores = torch.einsum("bclhn,bcuhn->bchlu", ch, bh)
        ct = cum.permute(0, 1, 3, 2)  # (B,nc,H,L)
        decay = ct[..., :, None] - ct[..., None, :]  # cum_t - cum_u
        causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
        m = torch.exp(decay.masked_fill(~causal, -1e30))
        xdt = xc * dtc[..., None]
        y_intra = torch.einsum("bchlu,bcuhp->bclhp", scores * m, xdt)
        # chunk states: S_c = sum_u exp(total - cum_u) B_u (dt_u x_u)
        suffix = torch.exp(total[:, :, None, :] - cum)
        state_c = torch.einsum("bclhn,bclh,bclhp->bchpn", bh, suffix, xdt)
        st = torch.zeros((bsz, h, p, n), dtype=acc_t, device=x.device)
        prev = []
        for c in range(nc):  # inter-chunk recurrence, chunks in order
            prev.append(st)
            st = st * torch.exp(total[:, c])[:, :, None, None] + state_c[:, c]
        prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)
        y_inter = torch.einsum("bclhn,bchpn,bclh->bclhp", ch, prev_states,
                               torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(out_t), st


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            bmat: torch.Tensor, cmat: torch.Tensor):
    """The sequential SSD recurrence, the exact oracle of the tests
    (``repro/kernels/ref.py::ssd_ref``):

        S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T;   y_t = S_t C_t

    Same arguments as ``ssd_chunked_ref`` without the chunk.  Returns
    (y (B, S, H, P) in x's dtype, the final state (B, H, P, N))."""
    acc_t = _acc_dtype(x, bmat, cmat)
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    xf, dtf, af = x.to(acc_t), dt.to(acc_t), a.to(acc_t)
    bh = bmat.to(acc_t).repeat_interleave(h // g, dim=2)
    ch = cmat.to(acc_t).repeat_interleave(h // g, dim=2)
    st = torch.zeros((bsz, h, p, n), dtype=acc_t, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)  # (B,H)
        st = st * decay[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xf[:, t], bh[:, t], dtf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), st
