"""The whole step's share of the card's bf16 peak: the model FLOPs of the
useful tokens the window served, over the window times 989e12 FLOP/s.

A request's useful FLOPs are those of its own prompt tokens and its
served tokens through the configuration's widths: per token and layer the
four attention projections, attention over the token's own context (its
prompt and the tokens before it, not the padding), the FFN (for experts,
the router and the k chosen experts), and per served token the
unembedding. A request counts by the share of its service in the window,
as ``output_tokens_per_s`` does."""
from perfbench.frozen.bound import PEAK_FLOPS_BF16
from perfbench.frozen.summary import overlap_share


def request_flops(m, prompt: int, served: int) -> float:
    D, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    L, F = m["num_layers"], m["d_ff"]
    proj = 2 * (2 * D * H * hd + 2 * D * KV * hd)
    if m.get("num_experts", 0):
        ffn = 2 * D * m["num_experts"] + \
            m["experts_per_token"] * 2 * 3 * D * F
    else:
        ffn = 2 * 3 * D * F
    n = prompt + served - 1              # tokens fed (the last is not)
    ctx = n * (n + 1) // 2               # sum of context lengths
    per_layer = n * (proj + ffn) + 4 * H * hd * ctx
    return L * per_layer + served * 2 * D * m["vocab_size"]


def read(run):
    done = [r for r in run.recs if r.done]
    if not done:
        return None
    fl = sum(request_flops(run.model, len(r.plan.tokens),
                           len(r.req.output))
             * overlap_share(r.req.service_start, r.req.completion,
                             run.w0, run.w1) for r in done)
    return 100.0 * fl / (run.seconds * PEAK_FLOPS_BF16)
