"""The dual scene's plain reference (``reference_dual.py``): it takes
nothing of the port, and its prestitched PAN2 is the stitch reference's
translation of PAN2 over the full width."""

import pytest
import torch

from portbench import harness, reference as ref, reference_dual as dual


def test_reference_dual_imports_nothing_of_the_port():
    text = (harness.HERE / "reference_dual.py").read_text()
    assert "opticalimageprocessor_tpu" not in text
    assert "jax" not in text.replace("JAX", "")


@pytest.mark.parametrize("dx, dy", [(-3.0, 2.0), (1.25, -0.5), (0.0, 0.0)])
def test_prestt_is_the_stitch_references_translation(dx, dy):
    """Right of the fold, the prestitched PAN2 is the stitched PAN's right
    half, block boundaries included."""
    g = torch.Generator().manual_seed(31)
    rows, width, fold = 200, 256, 20
    pan1, pan2 = (torch.randint(0, 65536, (rows, width), generator=g,
                                dtype=torch.int32).to(torch.uint16)
                  for _ in range(2))
    kb = tuple((0.98 + 0.04 * torch.rand(width, generator=g,
                                         dtype=torch.float64),
                20 * torch.randn(width, generator=g, dtype=torch.float64))
               for _ in range(2))
    block = ref.col_block_size(width, 128)
    p = dual.prestt(pan2, kb[1], dx, dy, block, 16, rows_per_block=64)
    st = ref.stitch(pan1, pan2, *kb, dx, dy, fold, block, 16,
                    rows_per_block=48)
    assert p.dtype == torch.uint16 and tuple(p.shape) == (rows, width)
    assert torch.equal(p[:, fold:], st[:, width - fold:])


def test_identity_table_leaves_a_corrected_strip():
    x = torch.arange(0, 65536, 7, dtype=torch.int32).to(torch.uint16)
    x = x.reshape(1, -1)
    for prec in (ref.Precision(), ref.Precision(low=True)):
        kb = dual.identity_table(x.shape[1], "cpu")
        assert torch.equal(ref.rrc(x, *kb, prec), x)
