"""Cross-attention and encoder members served over ranks against the
reference's sharded fleet: reduced whisper-tiny (a bidirectional encoder
over stub audio frames, cross-attention in every decoder layer, through
the audio lane) and llama-3.2-vision-90b (self-attention layers and a
cross-attention layer over zero patches for a text prompt).

The reference splits ``wq``/``wo`` over ``"model"`` where the query heads
divide it and ``wk``/``wv`` where the KV heads do, the FFN by ``d_ff``,
and keeps the cross-attention cache ``ck``/``cv`` whole
(``repro/sharding/rules.py``).  The port attends with the rank's query
heads and the KV heads they read (``models.model._rank_kv``: reduced
vision over 4 ranks splits its 4 query heads while its 2 KV heads stay
whole, the GQA group layout of the self-attention, now inside
cross-attention), all-gathers the rank's KV heads once at prefill to fill
the whole ``ck``/``cv``, and runs the encoder on every rank over the same
frames (the controller broadcasts them with the prefill).

Each case runs over ``data 1 x model M`` (M = 2 and 4 gloo CPU ranks; the
reference on 4 fake devices), float32, ``batch=2, max_seq=64,
gen_tokens=4``, ``decode_impl="xla"``.  Tokens must equal the reference's
and the port's unsharded fleet's, a mismatch waived only at a near-tie
(top-2 logit gap of the unsharded float32 member below 1e-4).  Within
the port: the leaves split over ``"model"`` are the reference's; the
frames and the encoded context are bitwise equal on every rank; vision
over 4 ranks holds one query head and every KV head of ``wk`` a rank;
``ck``/``cv`` are whole and equal to the unsharded fleet's; after a drain
every slot is free.
"""

import hashlib

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MD
from repro_torch.serving.fleet import LocalFleet, hash_tokens
from repro_torch.serving.serve_lib import on_mesh
from repro_torch.sharding import rules as R
from torch_shard_fleet_ref import near_tie
from torch_shard_fleet_ref import reference as fleet_reference

CASES = {"whisper-tiny": {"dtype": "float32"},
         "llama-3.2-vision-90b": {"dtype": "float32"}}
MODELS = (2, 4)
KW = dict(reduced=True, batch=2, max_seq=64, gen_tokens=4)
PROMPTS = ["shard me across hosts",
           "a second request that shares nothing with the first one",
           "tiny", " ".join(f"w{i}" for i in range(30))]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return fleet_reference(tmp_path_factory.mktemp("cross"), CASES, MODELS,
                           KW, PROMPTS)


def _cfg(arch):
    return get_reduced(arch).replace(**CASES[arch])


def _ids(cfg, prompt):
    if cfg.family == "audio":
        return [4]                 # an audio request decodes from BOS
    return list(hash_tokens(prompt, cfg.vocab_size,
                            KW["max_seq"] - KW["gen_tokens"] - 1))


def _context(cfg, prompt, lane):
    """The request's cross-attention context: the audio lane's frames, or
    a text prompt's zero patches."""
    if cfg.family == "audio":
        return lane._frames(prompt)
    return torch.zeros((1, cfg.cross_ctx_len, cfg.d_model))


def _same_or_near_tie(arch, named, got, want, lane):
    cfg = _cfg(arch)
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            assert near_tie(cfg, named, _ids(cfg, prompt), a, b,
                            _context(cfg, prompt, lane)), \
                (arch, prompt, a, b)


def _fleet(arch, **kw):
    return LocalFleet([arch], arch_overrides={arch: CASES[arch]},
                      decode_impl="xla", device="cpu", warmup=False,
                      **dict(KW, **kw))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def _rank_view(shard, frames):
    """One rank: its coordinates, every leaf's spec and shape, and the
    digests of ``frames`` as it received them and of the encoder's output
    over them (whisper; None for a member without an encoder)."""
    specs = {n: (None if getattr(p, "_spec", None) is None
                 else tuple(p._spec), tuple(p.shape))
             for n, p in shard.params.named_parameters()}
    enc = None
    if shard.cfg.encoder_groups:
        with on_mesh(shard.mesh), torch.no_grad():
            enc = _digest(MD._encode(shard.cfg, shard.params, frames,
                                     shard.moe_impl))
    return {"coords": shard.mesh.coords, "specs": specs,
            "frames": _digest(frames), "encoded": enc}


def _cross_cache(cache):
    """One rank: every ``ck``/``cv`` of its contiguous cache."""
    return {f"{g}/{b}/{leaf}": t.clone() for g, grp in cache.items()
            if g.startswith("g") for b, lv in grp.items()
            for leaf, t in lv.items() if leaf in ("ck", "cv")}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_cross_fleet_matches_reference_and_unsharded(reference, arch,
                                                             model):
    ref_tokens, ref_split = reference[arch][model]
    named = reference[arch]["named"]
    cfg = _cfg(arch)
    plain = _fleet(arch)
    plain.load_params(arch, named)
    lane = plain.lanes[arch]
    unsharded = [o["tokens"] for o in plain.generate(arch, PROMPTS)]
    _same_or_near_tie(arch, named, unsharded, ref_tokens, lane)
    want_cross = _cross_cache(plain.schedulers[arch].cache)
    frames = _context(cfg, PROMPTS[0], lane)
    with LM.host_ranks(model, device="cpu") as ctl:
        fleet = _fleet(arch, model_axis=model)
        assert fleet.mesh.shape == {"data": 1, "model": model}
        m = fleet.members[arch]
        assert not m.paged
        fleet.load_params(arch, named)
        got = [o["tokens"] for o in fleet.generate(arch, PROMPTS)]
        _same_or_near_tie(arch, named, got, ref_tokens, lane)
        _same_or_near_tie(arch, named, got, unsharded, lane)
        sched = fleet.schedulers[arch]
        assert sched.pending == 0 and all(a is None for a in sched.active)
        views = ctl.run(m.shard, "apply", _rank_view, frames, gather=True)
        crosses = ctl.gather(_cross_cache, sched.cache)
    specs = views[0]["specs"]
    # the port splits over "model" exactly the leaves the reference does
    assert {R.ref_path(cfg, n) for n, (s, _) in specs.items()
            if s is not None and "model" in s} == ref_split
    # one context on every rank, bit for bit
    assert len({v["frames"] for v in views}) == 1
    assert views[0]["frames"] == _digest(frames)
    if cfg.encoder_groups:
        assert views[0]["encoded"] is not None
        assert len({v["encoded"] for v in views}) == 1
    # ck / cv whole on every rank (the rules' cache spec), the unsharded
    # fleet's values
    assert crosses[0] and all(c.keys() == want_cross.keys() for c in crosses)
    for c in crosses:
        for key, t in c.items():
            assert t.shape[-2] == cfg.n_kv_heads, key
            torch.testing.assert_close(t, want_cross[key], rtol=1e-4,
                                       atol=1e-5)
    cross = next(f"blocks.{n}.attn" for n, b in enumerate(
        s for g in cfg.groups for _ in range(g.repeats) for s in g.period)
        if b.mixer == "cross_attn")
    wq, wk = specs[cross + ".wq"], specs[cross + ".wk"]
    hq = cfg.n_heads // (model if cfg.n_heads % model == 0 else 1)
    assert wq[1][1] == hq * cfg.head_dim
    if arch.startswith("llama") and model == 4:
        # the GQA group layout inside cross-attention: one query head a
        # rank, every KV head of wk on every rank
        assert wq[0] == ("data", "model") and hq == 1
        assert wk == (("data", None), (cfg.d_model,
                                       cfg.n_kv_heads * cfg.head_dim))


def test_serve_main_audio_lane_with_model_axis(capsys):
    """``launch/serve.py --model-axis 2 --lanes text,image,audio``: the
    whisper member serves its audio lane over the two ranks beside the
    text and image lanes; the last two of the 12 demo requests are audio
    requests and come back as transcripts."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--model-axis", "2", "--lanes",
                "text,image,audio", "--requests", "12", "--batch", "12",
                "--gen-tokens", "2"])
    out = capsys.readouterr().out
    assert "12 requests in" in out and "mesh {'data': 1, 'model': 2}" in out
    audio = [ln for ln in out.splitlines() if "lane=audio" in ln]
    assert sum("model=whisper" in ln for ln in audio) == 2, out
    line = next(ln for ln in audio if "backend whisper-tiny" in ln)
    assert "tokens=4 " in line, line
