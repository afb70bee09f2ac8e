"""PyTorch port, `gluon.model_zoo`: VGG (with BatchNorm), MobileNet v2
and Inception-v3 at 75 x 75 against the JAX package, as
`test_torch_model_zoo.py::check_family` holds them (evaluation logits,
one SGD step through the example's eager loop; tolerance 1e-4 of the
largest |value|, float32). A file of their own: their JAX steps compile
for the longest, and xdist spreads files."""
import pytest

from test_torch_model_zoo import check_family


@pytest.mark.parametrize("family", ["vgg11_bn", "mobilenetv2_0.5",
                                    "inceptionv3"])
def test_family_forward_and_sgd_step_match_jax(family):
    check_family(family)
