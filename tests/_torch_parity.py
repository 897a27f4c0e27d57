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
