"""Layer: towers. Device milliseconds per Gibbs step in matrix-product
kernels, by name: cuBLAS and CUTLASS kernels (``nvjet``, ``gemm``,
``sm90_``, ``cutlass``, ``xmma``, ``wgmma``, ``imma``). On the library
route (``attn_impl="xla"``) the attention einsums run here too. The
port's own kernels are never counted here."""

MATMUL = ("nvjet", "gemm", "Gemm", "sm90_", "cutlass", "xmma", "wgmma",
          "imma")
PORT = ("masked_attention_", "attention_with_out_", "attention_block_",
        "layer_norm_kernel")


def is_matmul(name: str) -> bool:
    return (any(k in name for k in MATMUL)
            and not any(k in name for k in PORT))


def read(trace):
    if not trace.kernels or not trace.steps:
        return None
    return 1e3 * trace.device_seconds(is_matmul) / trace.steps
