"""RWKV-6 Finch's time mix (arXiv:2404.05892 §4; RWKV-LM's
``RWKV_Tmix_x060``), x_{-1} = 0, heads of hd channels:

    dx = x_{t-1} - x;   xxx = x + dx * maa_x
    x_c = x + dx * (mu_c + tanh(xxx A) B_c)       c in w, k, v, r, g
    r, k, v = x_r W_r, x_k W_k, x_v W_v;   g = silu(x_g W_g)
    d_t = decay_base + tanh(x_w W_1) W_2;   w_t = exp(-exp(d_t))
    y_t = r_t (S_t + diag(u) k_t^T v_t);   S_{t+1} = diag(w_t) S_t + k_t^T v_t
    out = (GroupNorm(y) * g) W_o

with A = ``maa_w1`` (d, 5 r), B_c = ``maa_w2[i]`` (r, d) in the order
w, k, v, r, g, W_1 = ``decay_w1``, W_2 = ``decay_w2``, u = ``bonus_u``, S_0 =
0 per head, and the GroupNorm per head: its hd channels centred and scaled
to unit variance (eps 1e-5 * 8^2, RWKV-LM's ``ln_x``), then ``gn_scale`` and
``gn_bias``.

The WKV runs in the chunked matrix form of the same recurrence (``wkv``):
within a chunk each output is the chunk's start state carried forward plus
the earlier keys of the chunk, and the start states pass from chunk to
chunk.  Decays stay in log space, log w_t = -exp(d_t), finite where w_t
itself rounds to 0; every exponent taken is a sum of log-decays, never
above 0, and nothing divides by w.  Its intermediates are recomputed in the
backward (a checkpoint), so a 4096-token row fits beside the model.

Departures from the published model, stated by the benchmark's
configuration too: the embedding's LayerNorm ``ln0`` is left out, and the
block's LayerNorms (``norm_layernorm``) take the configuration's eps.
"""
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ffn_rwkv6_chan import shifted

MIX = "wkvrg"                     # the ddlerp targets, in B's order
GN_EPS = 1e-5 * 8 ** 2
CHUNK = 32


def apply(p: dict, x: torch.Tensor, cfg: dict, kind: str, nm
          ) -> torch.Tensor:
    return checkpoint(_time_mix, p, x, cfg, nm, use_reentrant=False)


def _time_mix(p: dict, x: torch.Tensor, cfg: dict, nm) -> torch.Tensor:
    B, T, d = x.shape
    H = cfg["n_heads"]
    hd = cfg.get("head_dim") or d // H
    dx = shifted(x) - x
    xxx = x + dx * p["maa_x"]
    lora = torch.tanh(nm.mm(xxx, p["maa_w1"])).view(B, T, len(MIX), -1)
    xs = {c: x + dx * (p[f"mu_{c}"] + nm.mm(lora[:, :, i], p["maa_w2"][i]))
          for i, c in enumerate(MIX)}

    def heads(c):
        return nm.mm(xs[c], p[f"w{c}"]).view(B, T, H, hd)

    r, k, v = heads("r"), heads("k"), heads("v")
    g = F.silu(heads("g"))
    dd = p["decay_base"] + nm.mm(torch.tanh(nm.mm(xs["w"], p["decay_w1"])),
                                 p["decay_w2"]).view(B, T, H, hd)
    y = wkv(r, k, v, -torch.exp(dd), p["bonus_u"])
    y = group_norm(y, p["gn_scale"], p["gn_bias"])
    return nm.mm((y * g).reshape(B, T, H * hd), p["wo"])


def group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """Each head's channels of y (B, T, H, hd) centred and scaled to unit
    variance, then ``scale`` and ``bias`` (H, hd)."""
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.mean((y - mean) ** 2, dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + GN_EPS) * scale + bias


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK
        ) -> torch.Tensor:
    """y (B, T, H, hd) of the recurrence from S_0 = 0, given r, k, v and
    the log-decays log_w (B, T, H, hd) and u (H, hd).  In a chunk of C
    steps, with L_t = the sum of log w over the chunk's steps before t:

        S_t = exp(L_t) S_start + sum_{s<t} exp(L_t - L_{s+1}) k_s^T v_s
        y_t = (r_t exp(L_t)) S_start
              + sum_{s<t} (sum_i r_t[i] k_s[i] exp(L_t[i] - L_{s+1}[i])) v_s
              + (r_t . (u * k_t)) v_t

    and the next chunk starts from S_C.  T is padded to whole chunks with
    zero keys, which change no earlier output."""
    B, T, H, hd = r.shape
    n = -(-T // chunk)

    def blocks(t):                # (B, T, H, hd) -> (B, H, n, C, hd)
        t = F.pad(t, (0, 0, 0, 0, 0, n * chunk - T))
        return t.view(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)

    r, k, v, lw = (blocks(t) for t in (r, k, v, log_w))
    # the sums in f64: a gap of a few steps between two sums of hundreds
    # of large log-decays keeps its digits, then leaves in r's precision
    excl = torch.cumsum(F.pad(lw.double(), (0, 0, 1, 0))[..., :-1, :],
                        dim=-2)                         # L_t
    incl = excl + lw                                    # L_{t+1}
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)[..., None]     # s < t
    gap = (excl[..., :, None, :] - incl[..., None, :, :]).to(r.dtype) \
        .masked_fill(~below, float("-inf"))             # (.., t, s, i)
    a = torch.einsum("bhnti,bhnsi,bhntsi->bhnts", r, k, torch.exp(gap))
    bonus = torch.sum(r * u[None, :, None, None, :] * k, dim=-1,
                      keepdim=True)
    y = torch.einsum("bhnts,bhnsj->bhntj", a, v) + bonus * v
    total = incl[..., -1:, :]                           # L_C
    ds = torch.einsum("bhnsi,bhnsj->bhnij",
                      k * torch.exp((total - incl).to(r.dtype)), v)
    S = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device)
    starts = []
    for c in range(n):
        starts.append(S)
        S = torch.exp(total[:, :, c, 0, :].to(r.dtype))[..., None] * S \
            + ds[:, :, c]
    y = y + torch.einsum("bhnti,bhnij->bhntj",
                         r * torch.exp(excl.to(r.dtype)),
                         torch.stack(starts, dim=2))
    return y.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, hd)[:, :T]
