"""The plain references against ``repro_torch`` at reduced sizes on the
CPU: the same drawn weights in both, every position's logits in float32.
The test imports both; the reference modules import nothing of the
program (checked on their sources here, and on a run's loaded modules in
``test_bench_harness``)."""

import ast
from pathlib import Path

import pytest
import torch

import bench_tiny
from reference.common import Exact, FP8, draw_block, hash_tokens, token_gaps
from vsrbench import spec as S

REF = Path(S.BENCH / "reference")


def _port(config: dict):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.models.config import BlockSpec, LayerGroup
    pm = S.family(config).port_model(config)
    fields = dict(pm["fields"], dtype="float32", attn_impl="einsum")
    cfg = get_config(pm["arch"]).replace(
        groups=tuple(LayerGroup((BlockSpec(m, f),), n)
                     for m, f, n in pm["groups"] if n), **fields)
    if cfg.n_experts:     # dropless, as the fleet serves it
        cfg = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return MD, cfg, params


@pytest.mark.parametrize("name", ["deepseek-v2-stage", "glm4-9b"])
def test_bench_reference_matches_the_port(name):
    config = bench_tiny.config(name)
    fam = S.family(config)
    blocks = fam.blocks(config)
    MD, cfg, params = _port(config)
    named = dict(params.named_parameters())
    assert set(named) == {n for b in blocks for n, *_ in b}
    seed = 2 ** 31 + 77
    with torch.no_grad():
        for i, leaves in enumerate(blocks):
            for n, t in draw_block(leaves, seed, i, "cpu").items():
                named[n].copy_(t)
    torch.manual_seed(0)
    toks = [torch.randint(4, 256, (37,)), torch.randint(4, 256, (12,))]
    ref = fam.forward(config, lambda i: draw_block(blocks[i], seed, i, "cpu"),
                      toks, [(0, 37), (3, 9)], Exact())
    for t, r, (a, b) in zip(toks, ref, [(0, 37), (3, 9)]):
        with torch.no_grad():
            got, _ = MD.forward(cfg, params, t[None], moe_impl="sort")
        assert r.shape == (b - a, 256)
        torch.testing.assert_close(got[0, a:b].float(), r, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", ["deepseek-v2-stage", "glm4-9b"])
def test_bench_control_reads_wider_than_the_reference(name):
    """The fp8 control moves the first choice away from the reference's
    best on some positions, where the reference against itself reads 0."""
    config = bench_tiny.config(name)
    fam = S.family(config)
    blocks = fam.blocks(config)
    for seed in (1, 2, 3):
        w = lambda i: draw_block(blocks[i], seed, i, "cpu")  # noqa: E731
        toks = [torch.randint(4, 256, (48,),
                              generator=torch.Generator().manual_seed(seed))]
        ref = fam.forward(config, w, toks, [(0, 48)], Exact())[0]
        low = fam.forward(config, w, toks, [(0, 48)], FP8())[0]
        assert float(token_gaps(ref, ref.argmax(1).tolist()).max()) == 0.0
        assert float(token_gaps(ref, low.argmax(1).tolist()).max()) > 0.0


def test_bench_draws_are_seeded_and_blockwise():
    config = bench_tiny.config("deepseek-v2-stage")
    blocks = S.family(config).blocks(config)
    a = draw_block(blocks[2], 5, 2, "cpu")
    b = draw_block(blocks[2], 5, 2, "cpu")
    c = draw_block(blocks[2], 6, 2, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert a[k].dtype == (torch.float32 if k.endswith("router")
                              else torch.bfloat16)


def test_bench_hash_tokens_are_the_fleets():
    from repro_torch.serving.fleet import hash_tokens as port
    text = "Alpha beta\ngamma " * 30
    assert hash_tokens(text, 256, 40) == port(text, 256, 40).tolist()
    assert hash_tokens("", 256, 40) == [4]


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")),
                         ids=lambda p: p.name)
def test_bench_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in ("torch", "numpy", "math", "hashlib",
                                       "typing", "reference", "__future__"), n
