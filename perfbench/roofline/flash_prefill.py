"""``flash_prefill``: causal attention over a prefill call's rows.

One launch a layer a prefill call, over (B, S) = (max_batch, prompt_len)
bf16: q and out (B, S, H, hd), k and v (B, S, KV, hd), each read or written
once; QK^T and PV over the lower triangle, the diagonal included."""
MATCH = "flash_prefill"


def counts(model, geometry):
    """(flops, bytes) of one launch."""
    B, S = geometry["max_batch"], geometry["prompt_len"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    pairs = S * (S + 1) // 2
    flops = 2 * 2 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return flops, nbytes
