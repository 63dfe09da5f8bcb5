"""`ops/_build.py::plain_versions`, the one switch from the diffusion
kernels (L1, L2, N1) to their plain versions: it nests and leaves the
switch as it found it. What each reader does inside it is tested beside
that reader (tests/test_torch_flash_attention.py, test_torch_short_attention.py,
test_torch_group_norm.py), and on the card by
tests/test_torch_cuda_plain_versions.py.
"""

import pytest

from guidedvd3dgs_tpu_torch.ops import _build


def test_scope_nests_and_restores():
    assert not _build.forced_plain()
    with _build.plain_versions():
        assert _build.forced_plain()
        with _build.plain_versions():
            assert _build.forced_plain()
        assert _build.forced_plain()
    assert not _build.forced_plain()


def test_scope_restores_on_an_exception():
    with pytest.raises(RuntimeError, match="inside"):
        with _build.plain_versions():
            with _build.plain_versions():
                raise RuntimeError("inside")
    assert not _build.forced_plain()
