"""The port's serving entry point (`repro_torch.launch.serve`) on the CPU.

The CLI runs every ported arch at smoke size with ``--device cpu``; the
tokens are (batch, new_tokens) and a seed fixes them. On the CPU the
kernel path takes the kernels' plain versions, so no kernel launches.
Without ``--device`` the entry point targets the card, and raises when
there is none (it never falls back to the CPU on its own).
"""

import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_smoke_config
from repro_torch.kernels._build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import get_model

ARGS = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--new-tokens", "5"]


def _prompt_len(cfg, n: int) -> int:
    """``n``, or more for a vision-stub model: its stub fills the first 16
    positions of the prompt."""
    return max(n, 20) if cfg.modality == "vision_stub" else n


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_cli_serves_on_cpu_deterministically(arch, capsys):
    before = dict(LAUNCHES)
    n = _prompt_len(get_smoke_config(arch), 12)
    args = [*ARGS[:-3], str(n), *ARGS[-2:]]
    r1 = serve.main(["--arch", arch, *args])
    r2 = serve.main(["--arch", arch, *args])
    assert LAUNCHES == before
    toks = r1["tokens"]
    assert toks.shape == (2, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < get_smoke_config(arch).vocab
    assert torch.equal(toks, r2["tokens"])
    assert r1["prefill_s"] > 0 and r1["decode_s_per_tok"] > 0
    out = capsys.readouterr().out
    assert f"served {get_smoke_config(arch).name} on cpu batch=2 prompt={n} new=5" in out


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_serve_matches_prefill_plus_decode(arch):
    """serve() is prefill then greedy decode: the first token is the
    prefill's argmax, and a prompt one token longer reproduces step 2."""
    cfg = get_smoke_config(arch)
    n = _prompt_len(cfg, 10)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    r = serve.serve(model, batch=2, prompt_len=n, new_tokens=3, seed=4)
    prompts = serve.make_prompts(cfg.vocab, 2, n, seed=4, device="cpu")
    assert torch.equal(prompts, torch.randint(
        0, cfg.vocab, (2, n), generator=torch.Generator().manual_seed(5), dtype=torch.int64
    ))
    kw = serve.prefill_kwargs(cfg, 2, "cpu")
    logits, _ = model.prefill(prompts, **kw)
    assert torch.equal(r["tokens"][:, :1], logits[:, -1].argmax(-1, keepdim=True))
    logits2, _ = model.prefill(torch.cat([prompts, r["tokens"][:, :1]], dim=1), **kw)
    assert torch.equal(r["tokens"][:, 1:2], logits2[:, -1].argmax(-1, keepdim=True))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"])
def test_cli_serves_moe_and_vlm_with_the_stub(arch, monkeypatch):
    """The CLI on the MoE and VLM smoke configs: a vision-stub model's
    prefill gets the reference's stand-in embeddings, (batch, 16, D) of
    0.01 in the model dtype, and serves what ``prefill`` with them
    gives; a text model's prefill gets none. `PlainRuntime.prefill_step`
    passes a batch's ``extra_embeds`` on."""
    from repro_torch.distributed import PlainRuntime
    from repro_torch.models.transformer import Transformer

    seen = []
    prefill = Transformer.prefill

    def recording_prefill(self, tokens, extra_embeds=None, extra_slots=0):
        seen.append(extra_embeds)
        return prefill(self, tokens, extra_embeds=extra_embeds, extra_slots=extra_slots)

    monkeypatch.setattr(Transformer, "prefill", recording_prefill)
    cfg = get_smoke_config(arch)
    n = _prompt_len(cfg, 12)
    r = serve.main(["--arch", arch, *ARGS[:-3], str(n), *ARGS[-2:]])
    assert len(seen) == 1
    if cfg.modality == "vision_stub":
        assert torch.equal(seen[0], torch.full((2, 16, cfg.d_model), 0.01))
    else:
        assert seen[0] is None
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = serve.make_prompts(cfg.vocab, 2, n, seed=0, device="cpu")
    batch = {"tokens": prompts, **serve.prefill_kwargs(cfg, 2, "cpu")}
    logits, _ = PlainRuntime(model).prefill_step(batch)
    assert torch.equal(r["tokens"][:, :1], logits[:, -1].argmax(-1, keepdim=True))
    if cfg.modality == "vision_stub":
        plain, _ = model.prefill(prompts)
        assert not torch.equal(plain, logits)  # the stub changed the prefill


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(get_smoke_config("qwen3-0.6b"))
