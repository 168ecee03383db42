"""Masked multi-head attention: the CUDA kernel ``csrc/masked_attention.cu``
and its plain version.

Counterpart of ``fused_masked_attention`` / ``masked_softmax_core`` in
``conzic_tpu/ops/fused_attention.py``. Every attention of the port's three
towers that no fused kernel takes goes through :func:`masked_attention`: a
tensor on the CPU takes :func:`masked_attention_plain`, a tensor on a CUDA
device takes the kernel, and anything the kernel does not take raises.

The prefix form. With ``prefix_kv=(pk, pv)``, both (B, P, H, D), the keys
and values of row n of q (N, Sq, H, D) are ``concat(pk[n // G], k[n])``
and ``concat(pv[n // G], v[n])`` with k, v (N, Ss, H, D), N = B * G and
Ss >= Sq: the prompt prefix of the row's image, then the row's own. The
function is ``fused_masked_attention`` on those concatenated keys, Sk =
P + Ss, with ``lens`` and the causal rule (col <= row + (Sk - Sq)) counted
over them. The kernel reads the prefix once per image instead of a
broadcast copy per row; the plain version broadcasts and concatenates.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from conzic_torch.kernels import build
from conzic_torch.ops.attention import NEG_INF, attention_keep_mask

_DTYPES = (torch.float32, torch.bfloat16)


PrefixKV = Tuple[torch.Tensor, torch.Tensor]


def with_prefix(k: torch.Tensor, v: torch.Tensor,
                prefix_kv: PrefixKV) -> PrefixKV:
    """The logical keys and values of the prefix form: each image's (B, P,
    H, D) prefix broadcast to its G = N // B rows and put before the rows'
    own (N, Ss, H, D) keys and values."""
    pk, pv = prefix_kv
    N = k.shape[0]
    B, P, H, D = pk.shape
    G = N // B

    def cat(p, own):
        p = p[:, None].expand(B, G, P, H, D)
        return torch.cat([p.reshape(N, P, H, D), own], dim=1)

    return cat(pk, k), cat(pv, v)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lens: Optional[torch.Tensor] = None,
                           causal: bool = False,
                           prefix_kv: Optional[PrefixKV] = None
                           ) -> torch.Tensor:
    """A transcription of ``masked_softmax_core``: fp32 logits scaled by
    D^-0.5, masked logits replaced by -1e9, fp32 softmax, weights rounded
    to the value type, fp32 weighted sum, output in q's type. A prefix is
    broadcast and concatenated first (:func:`with_prefix`)."""
    if prefix_kv is not None:
        check_prefix("masked_attention_plain", q, k, prefix_kv)
        k, v = with_prefix(k, v, prefix_kv)
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    logits = (qf @ kf.transpose(-1, -2)) * D ** -0.5  # (N, H, Sq, Sk)
    keep = attention_keep_mask(lens, N, Sq, Sk, causal, q.device)
    logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    w = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    out = w.float() @ vf
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("masked_attention")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conzic_masked_attention.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.conzic_masked_attention.restype = i
        lib.conzic_masked_attention_max_keys.restype = i
        lib.conzic_masked_attention_max_head_dim.restype = i
        lib._conzic_typed = True
    return lib


def check_on_device(what: str, first: torch.Tensor, tensors) -> None:
    """Raise unless every (name, tensor) lies on the device of ``first``
    and is contiguous."""
    for name, t in tensors:
        if t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_lens(what: str, lens: Optional[torch.Tensor], N: int) -> None:
    if lens is not None and (lens.dtype != torch.int32
                             or lens.shape != (N,)):
        raise ValueError(f"{what}: lens must be int32 ({N},), got "
                         f"{lens.dtype} {tuple(lens.shape)}")


def check_qkv(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lens: Optional[torch.Tensor]) -> None:
    """Raise on anything in q (N, Sq, H, D), k, v (N, Sk, H, D), lens (N,)
    that the attention kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-D (N, S, H, D)")
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (N, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if Sk < Sq:
        raise ValueError(f"{what}: Sk={Sk} < Sq={Sq}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: types q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; one of {_DTYPES} expected")
    check_lens(what, lens, N)
    tensors = [("q", q), ("k", k), ("v", v)]
    if lens is not None:
        tensors.append(("lens", lens))
    check_on_device(what, q, tensors)


def check_prefix(what: str, q: torch.Tensor, k: torch.Tensor,
                 prefix_kv: PrefixKV) -> None:
    """Raise unless pk, pv are (B, P, H, D) in q's type, with B dividing
    the N rows of q and k (N, Ss, H, D), and Ss >= Sq."""
    pk, pv = prefix_kv
    N, Sq, H, D = q.shape
    if pk.dim() != 4 or pv.shape != pk.shape:
        raise ValueError(f"{what}: prefix shapes pk={tuple(pk.shape)} "
                         f"pv={tuple(pv.shape)}")
    B = pk.shape[0]
    if pk.shape[2:] != (H, D) or B == 0 or N % B:
        raise ValueError(f"{what}: prefix {tuple(pk.shape)} does not serve "
                         f"q {tuple(q.shape)} (B must divide N, same H, D)")
    if k.dim() != 4 or k.shape[1] < Sq:
        raise ValueError(f"{what}: the rows' own keys {tuple(k.shape)} must "
                         f"number at least Sq={Sq}")
    if pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise TypeError(f"{what}: prefix types pk={pk.dtype} pv={pv.dtype}, "
                        f"q is {q.dtype}")


def check_limits(what: str, Sk: int, D: int, max_keys: int,
                 max_head_dim: int) -> None:
    if Sk > max_keys:
        raise ValueError(f"{what}: Sk={Sk} exceeds the kernel's {max_keys} "
                         f"keys")
    if D > max_head_dim:
        raise ValueError(f"{what}: D={D} exceeds the kernel's "
                         f"{max_head_dim}")


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: Optional[torch.Tensor] = None,
                     causal: bool = False,
                     prefix_kv: Optional[PrefixKV] = None) -> torch.Tensor:
    """q (N, Sq, H, D); k, v (N, Ss, H, D) with Ss >= Sq; ``prefix_kv``
    None (Sk = Ss) or (pk, pv), each (B, P, H, D) with N = B * G, put before
    the keys of row n as image n // G's (Sk = P + Ss); lens (N,) valid KEY
    lengths over the Sk keys or None (= Sk); ``causal`` masks col > row +
    (Sk - Sq). Returns (N, Sq, H, D) in q's type."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, lens, causal, prefix_kv)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: no kernel for device {q.device}")
    what = "masked_attention"
    check_qkv(what, q, k, v, lens)
    N, Sq, H, D = q.shape
    pk = pv = None
    P = 0
    if prefix_kv is not None:
        check_prefix(what, q, k, prefix_kv)
        pk, pv = prefix_kv
        check_on_device(what, q, [("pk", pk), ("pv", pv)])
        P = pk.shape[1]
    lib = _lib()
    check_limits(what, P + k.shape[1], D,
                 lib.conzic_masked_attention_max_keys(),
                 lib.conzic_masked_attention_max_head_dim())
    out = torch.empty_like(q)
    code = lib.conzic_masked_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pk.data_ptr() if pk is not None else None,
        pv.data_ptr() if pv is not None else None,
        lens.data_ptr() if lens is not None else None, out.data_ptr(),
        N, Sq, k.shape[1], P, N // pk.shape[0] if pk is not None else 1, H, D,
        int(causal), float(D ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, code, "masked_attention")
    build.count_launch(masked_attention)
    return out


masked_attention.launches = 0
