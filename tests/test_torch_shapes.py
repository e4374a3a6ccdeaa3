"""The port's analytic counts and shape cells against the reference's.

``models.config.param_count`` (all, without the embedding, active
experts only) and ``model_flops`` (train and serve) are pure Python in
both packages: equal integers for all ten archs of the registry, at their
published and their reduced widths.  ``configs.shapes``: ``SHAPES``,
``applicable`` and ``cells(include_skips=...)`` equal the reference's.
"""

import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import shapes as JS
from repro.models import config as JC
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.configs import shapes as S
from repro_torch.models import config as C


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_count_and_model_flops_match_reference(arch, reduced):
    cfg = (get_reduced if reduced else get_config)(arch)
    ref = (jget_reduced if reduced else jget_config)(arch)
    for kw in ({}, {"include_embed": False},
               {"include_embed": False, "active_only": True},
               {"active_only": True}):
        got = C.param_count(cfg, **kw)
        assert isinstance(got, int) and got > 0
        assert got == JC.param_count(ref, **kw), kw
    for mode in ("train", "serve"):
        for n in (1, 128, 256 * 4096):
            assert C.model_flops(cfg, n, mode=mode) == \
                JC.model_flops(ref, n, mode=mode), (mode, n)
    assert C.model_flops(cfg, 10, "train") == \
        3 * C.model_flops(cfg, 10, "serve")


def test_param_count_of_published_configs():
    """Spot values: smollm-360m's 361.8 M parameters (tied embedding) and
    the MoE members' active parameters well below their totals."""
    assert C.param_count(get_config("smollm-360m")) == 361_821_120
    for arch in ("deepseek-v2-236b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch)
        assert C.param_count(cfg, active_only=True) < \
            C.param_count(cfg) / 5


def test_shapes_match_reference():
    assert list(S.SHAPES) == list(JS.SHAPES)
    for name, cell in S.SHAPES.items():
        ref = JS.SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    for arch in list_archs():
        for shape in S.SHAPES:
            assert S.applicable(arch, shape) == JS.applicable(arch, shape)
    for skips in (False, True):
        assert list(S.cells(include_skips=skips)) == \
            list(JS.cells(include_skips=skips))
    assert len(list(S.cells(include_skips=True))) == 40
    assert [(a, s) for a, s, ok in S.cells(include_skips=True)
            if not ok] == [(a, "long_500k") for a in list_archs()
                           if not get_config(a).sub_quadratic]
