"""The port's serving entry point (`repro_torch.launch.serve`) on the CPU.

The CLI runs both ported archs at smoke size with ``--device cpu``; the
tokens are (batch, new_tokens) and a seed fixes them. On the CPU the
kernel path takes the kernels' plain versions, so no kernel launches.
Without ``--device`` the entry point targets the card, and raises when
there is none (it never falls back to the CPU on its own).
"""

import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.kernels.flash_attention import LAUNCHES as FA_LAUNCHES
from repro_torch.kernels.rglru_scan import LAUNCHES as RG_LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import get_model

ARGS = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--new-tokens", "5"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu_deterministically(arch, capsys):
    before = (dict(FA_LAUNCHES), dict(RG_LAUNCHES))
    r1 = serve.main(["--arch", arch, *ARGS])
    r2 = serve.main(["--arch", arch, *ARGS])
    assert (dict(FA_LAUNCHES), dict(RG_LAUNCHES)) == before
    toks = r1["tokens"]
    assert toks.shape == (2, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < get_smoke_config(arch).vocab
    assert torch.equal(toks, r2["tokens"])
    assert r1["prefill_s"] > 0 and r1["decode_s_per_tok"] > 0
    out = capsys.readouterr().out
    assert f"served {get_smoke_config(arch).name} on cpu batch=2 prompt=12 new=5" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_prefill_plus_decode(arch):
    """serve() is prefill then greedy decode: the first token is the
    prefill's argmax, and a prompt one token longer reproduces step 2."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    r = serve.serve(model, batch=2, prompt_len=10, new_tokens=3, seed=4)
    prompts = serve.make_prompts(cfg.vocab, 2, 10, seed=4, device="cpu")
    assert torch.equal(prompts, torch.randint(
        0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(5), dtype=torch.int64
    ))
    logits, _ = model.prefill(prompts)
    assert torch.equal(r["tokens"][:, :1], logits[:, -1].argmax(-1, keepdim=True))
    logits2, _ = model.prefill(torch.cat([prompts, r["tokens"][:, :1]], dim=1))
    assert torch.equal(r["tokens"][:, 1:2], logits2[:, -1].argmax(-1, keepdim=True))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(get_smoke_config("qwen3-0.6b"))
