"""The bf16 decode step kernel (``flash_decode_step_kernel``): one token a
row against the dense ring.

One launch a layer a decode step, over B = max_batch rows of G = H / KV
query heads a KV head, against a ring of C = prompt_len + max_new
positions: q and out (B, KV, G, hd) bf16, the ring's k and v (B, KV, C,
hd) bf16 and the validity bias (B, C) float32, each read once (the dense
loader reads the whole ring; the rows the engine serves hold 512 to 575
valid positions of 576)."""
MATCH = "flash_decode_step_kernel"


def counts(model, geometry):
    """(flops, bytes) of one launch."""
    B = geometry["max_batch"]
    C = geometry["prompt_len"] + geometry["max_new"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    G = H // KV
    flops = 2 * 2 * B * KV * G * C * hd
    nbytes = 2 * (2 * B * KV * G * hd + 2 * B * KV * C * hd) + 4 * B * C
    return flops, nbytes
