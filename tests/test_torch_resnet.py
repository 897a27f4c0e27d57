"""The paper's ResNet family (the InfAdapter backends) in the port,
against the reference's ``repro.models.resnet``, on the CPU.

The mirror of ``tests/test_resnet.py`` (forward shapes and finite logits
of ResNet-18/34/50 at 10 classes; the accuracy ladder monotone); the
constants equal; ``init_resnet``'s tree equal to the reference's, key for
key and shape for shape, with its draws' statistics; ``apply_resnet`` of
all five variants on the reference's weights (``bridge.
resnet_params_from_jax``) at an even (32) and an odd (33) image size,
where ``"SAME"`` pads asymmetrically at stride 2, within 1e-5 of the
logits' largest magnitude (fp32 convolutions summed in other orders; the
deep random variants' logits reach 1e7); ``resnet_flops``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro.models import resnet as jr
from repro_torch.bridge import resnet_params_from_jax
from repro_torch.models import resnet as pr

NAMES = list(jr.RESNET_SPECS)
REL_TOL = 1e-5


# ------------------------------------------------------------ tests/test_resnet.py
@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_resnet_forward(name):
    p = pr.init_resnet(torch.Generator().manual_seed(0), name,
                       num_classes=10)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    y = pr.apply_resnet(p, name, x)
    assert y.shape == (2, 10)
    assert bool(torch.isfinite(y).all())


def test_accuracy_ladder_monotone():
    accs = [pr.RESNET_SPECS[n][2] for n in
            ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]]
    assert accs == sorted(accs)


# ------------------------------------------------------------ parity
def test_constants_equal_reference():
    assert pr.RESNET_SPECS == jr.RESNET_SPECS
    assert pr.STAGE_WIDTHS == jr.STAGE_WIDTHS


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_equals_reference(name):
    """Key for key, shape for shape (``eval_shape``: nothing drawn on the
    reference's side); He-normal convolutions, unit scales, zero shifts."""
    want = jax.eval_shape(lambda k: jr.init_resnet(k, name),
                          jax.random.PRNGKey(0))
    p = pr.init_resnet(torch.Generator().manual_seed(0), name)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert shapes == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    assert shapes == pr.resnet_shapes(name)
    stem = p["stem"]
    assert abs(float(stem.std()) - (2.0 / (7 * 7 * 3)) ** 0.5) < 0.01
    assert torch.equal(p["s0b0"]["c1_scale"], torch.ones(64))
    assert float(p["s0b0"]["c1_shift"].abs().max()) == 0.0
    assert abs(float(p["head"].std()) - 0.01) < 1e-3


@pytest.mark.parametrize("image", [32, 33])
@pytest.mark.parametrize("name", NAMES)
def test_apply_resnet_matches_reference(name, image):
    jp = jr.init_resnet(jax.random.PRNGKey(0), name, num_classes=10)
    pp = resnet_params_from_jax(jax.tree_util.tree_map(np.array, jp), name,
                                "cpu", num_classes=10)
    x = np.random.default_rng(image).standard_normal(
        (2, image, image, 3)).astype(np.float32)
    want = np.asarray(jr.apply_resnet(jp, name, jnp.asarray(x)))
    got = pr.apply_resnet(pp, name, torch.as_tensor(x))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(to_np(got) - want).max() <= REL_TOL * scale


def test_same_padding_is_asymmetric_at_stride_2():
    """The stem at 224 pads (2, 3), a 3x3 stride-2 convolution at 56 pads
    (0, 1), the pool (0, 1); stride 1 pads symmetrically."""
    assert pr._same_pads(224, 7, 2) == (2, 3)
    assert pr._same_pads(56, 3, 2) == (0, 1)
    assert pr._same_pads(112, 3, 2) == (0, 1)
    assert pr._same_pads(33, 3, 2) == (1, 1)
    assert pr._same_pads(56, 3, 1) == (1, 1)
    assert pr._same_pads(56, 1, 2) == (0, 0)


def test_bridge_refuses_a_wrong_tree():
    jp = jax.tree_util.tree_map(
        np.array, jr.init_resnet(jax.random.PRNGKey(0), "resnet18",
                                 num_classes=10))
    with pytest.raises(ValueError, match="num_classes|head|shape"):
        resnet_params_from_jax(jp, "resnet18", "cpu")       # 1000 classes
    del jp["s1b0"]["proj"]
    with pytest.raises(ValueError, match="proj"):
        resnet_params_from_jax(jp, "resnet18", "cpu", num_classes=10)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("image", [224, 112])
def test_resnet_flops_equals_reference(name, image):
    assert pr.resnet_flops(name, image) == jr.resnet_flops(name, image)
