"""Card-only checks (marker ``gpu``): the compiled Triton kernel, never the
interpreter. They skip on the CPU; ``chip_smoke.py`` runs the same checks
at full size as its kernel-vs-jnp and compiled phases."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_lowered_render_is_compiled_triton(gpu):
    txt = chip_smoke.lowered_render_text()
    assert chip_smoke.TRITON_CALL in txt
    assert "stablehlo.while" not in txt


@pytest.mark.parametrize("config", ["two_sphere", "demo"])
def test_kernel_matches_jnp_on_card(gpu, config):
    """Statistical agreement (lowbias32 counters vs threefry keys) and a
    bitwise rerun. No matrix products remain on either path, so TF32
    never enters the comparison."""
    mad, bitwise, _, _ = chip_smoke.check_kernel_vs_jnp(config, 128, 64)
    assert bitwise
    assert mad < chip_smoke.KERNEL_VS_JNP_BOUND
