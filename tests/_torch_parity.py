"""Helpers shared by the ``test_torch_*`` parity tests: build the port's
config from the reference's field dict, carry the reference's weights
across, and keep torch to one CPU thread under the xdist workers."""
import dataclasses

import numpy as np
import torch

# one intra-op thread: the parity shapes are tiny, and the xdist workers
# share the host's cores with the reference's timing-sensitive tests
torch.set_num_threads(1)


def port_config(jcfg, **overrides):
    """The port's ModelConfig with every field of the reference's
    (``use_pallas`` is ``use_kernels`` in the port)."""
    from repro_torch.configs.base import ModelConfig
    d = dataclasses.asdict(jcfg)
    d["use_kernels"] = d.pop("use_pallas")
    d.update(overrides)
    return ModelConfig(**d)


def np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.array, tree)    # writable copies


def reference_init(jcfg, seed=0):
    """The reference's ``LM.init`` params (jitted: eager init is slow)."""
    import jax
    from repro.models.model import build_model
    return jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(seed))


def bridged_params(jcfg, seed=0, pcfg=None):
    """(reference params, port params on the CPU) from one reference init."""
    from repro_torch.bridge import params_from_jax
    jp = reference_init(jcfg, seed)
    return jp, params_from_jax(np_tree(jp), pcfg or port_config(jcfg), "cpu")


def to_np(t):
    return t.detach().cpu().float().numpy()


def port_variants(jvariants):
    """The port's variant map from the reference's (name -> (cfg, acc))."""
    return {n: (port_config(c), a) for n, (c, a) in jvariants.items()}


_WEIGHTS = {}


def reference_weights(jvariants):
    """Port weights (CPU) of each variant, taken from a reference engine's
    own backends (the seeded init every reference backend of that config
    draws), cached per variant set."""
    key = tuple(sorted((n, c) for n, (c, _) in jvariants.items()))
    if key not in _WEIGHTS:
        from repro.serving.engine import InProcessServingEngine
        from repro_torch.bridge import params_from_jax
        eng = InProcessServingEngine(jvariants, max_batch=1, prompt_len=4,
                                     max_new=2, decode_chunk=1)
        eng.apply_allocation(0.0, {n: 1 for n in jvariants})
        _WEIGHTS[key] = {
            n: params_from_jax(np_tree(eng.backends[n].params),
                               port_config(jvariants[n][0]), "cpu")
            for n in jvariants}
    return _WEIGHTS[key]


def serve_staggered(eng, request_cls, *, n=8, seed=0, sharing=False,
                    tight=False, prompt_len=8, vocab=128, max_new=6,
                    backend=None, max_ticks=600):
    """One staggered workload on the engine's virtual clock ``eng.t`` (a
    one-element list the engine's ``clock`` reads): a request per tick,
    then ticks until every queue and slot is empty. With ``sharing`` half
    the prompts reuse a common prefix; with ``tight`` even rids get a 30 ms
    SLO (hopeless after a tick or so, so EDF preemption fires) and odd rids
    5 s. Returns the engine's finished requests; raises if it never
    drains."""
    t = eng.t
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prompt_len // 2)
    for i in range(n):
        if sharing and i % 2:
            toks = np.concatenate(
                [shared, rng.integers(0, vocab, prompt_len - len(shared))])
        else:
            toks = rng.integers(0, vocab, prompt_len)
        slo = (30.0 if i % 2 == 0 else 5000.0) if tight else 0.0
        eng.submit(request_cls(rid=i, tokens=toks,
                               max_new=int(rng.integers(2, max_new + 1)),
                               arrival=t[0], slo_ms=slo), backend)
        eng.step(t[0])
        t[0] += 0.05
    for _ in range(max_ticks):
        if not eng.backlog(t[0]) and not eng.in_flight():
            return list(eng.done)
        eng.step(t[0])
        t[0] += 0.05
    raise AssertionError("the engine did not drain")


def outcome(done):
    """rid -> (backend, output list, dropped, preemptions) of requests."""
    return {r.rid: (r.backend, [int(x) for x in r.output], bool(r.dropped),
                    int(r.preemptions)) for r in done}
