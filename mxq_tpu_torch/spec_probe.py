"""Two probes of a tree of this package on the card, for comparisons
between commits (``--root``: the directory holding the ``mxq_tpu_torch``
to probe, e.g. a ``git archive`` of another commit; run this file by its
path so that the package is imported from there):

    python3 mxq_tpu_torch/spec_probe.py --patterns 10
    python3 mxq_tpu_torch/spec_probe.py --root out/parent --patterns 0

1. The packer and the QAT fake-quants on the card against the CPU:
   ``quantize_pack`` of one random llama2_7b gate_proj (11008 x 4096,
   bf16, seed 0), and ``sym_fake_quant`` at 8 and 4 bits,
   ``sym_fake_quant_ref3d``, ``asym_fake_quant`` at 4 bits,
   ``mxq_fake_quant_qat`` and ``mx1_fake_quant_qat`` of a (256, 4096)
   standard normal drawn after it from the same generator; one JSON line
   with the entries of each packed field and each fake-quant's outputs
   that differ. ``--patterns 0`` stops here.
2. Speculative decoding against plain decode, ``chip_smoke.py``'s serve
   check over more prompts: llama2_7b at full depth in f32, random weights
   from seed 0 packed on the card, 8 requests repeating a 16-token pattern
   (request i rolled by i), 32 new tokens, greedy, with speculation always
   on and without. Pattern p is drawn from seed p after the serve phase's
   own draws, so pattern 0 is the check's. One JSON line a pattern: the
   requests whose tokens equal plain decode's, and
   ``chip_smoke.spec_against_decode`` (teacher-forced along the spec
   tokens).
Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import sys

# the lengths of the serve phase's draws from its rng before its pattern
SERVE_DRAWS = (100, 400, 1500, 100, 400, 1500, 100, 100, 512) + (32,) * 8


def fake_quants_differing(x) -> dict:
    """The outputs of each QAT fake-quant of ``x`` (a CUDA tensor [256,
    4096]: the training and eval-ppl forward's w_bits, a_bits and
    kv_bits) that differ from the same call on a CPU copy, by function."""
    from mxq_tpu_torch import scheme
    fns = {"sym8": lambda v: scheme.sym_fake_quant(v, 8),
           "sym4": lambda v: scheme.sym_fake_quant(v, 4),
           "sym8_ref3d": lambda v: scheme.sym_fake_quant_ref3d(
               v.reshape(2, 128, 4096), 8),
           "asym4": lambda v: scheme.asym_fake_quant(v, 4),
           "mxq_qat": scheme.mxq_fake_quant_qat,
           "mx1": scheme.mx1_fake_quant_qat}
    return {k: int((f(x).cpu() != f(x.cpu())).sum()) for k, f in fns.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory holding the mxq_tpu_torch to probe "
                         "(default: this file's tree)")
    ap.add_argument("--patterns", type=int, default=1)
    args = ap.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.abspath(args.root or repo), repo]

    import numpy as np
    import torch

    import chip_smoke
    from mxq_tpu_torch import packfmt
    from mxq_tpu_torch.models import llama
    from mxq_tpu_torch.serving import engine as eng
    from mxq_tpu_torch.serving import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = args.root or "."
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (torch.randn((11008, 4096), generator=gen, device="cuda")
         / 64.0).to(torch.bfloat16)
    card, host = packfmt.quantize_pack(w), packfmt.quantize_pack(w.cpu())
    x = torch.randn((256, 4096), generator=gen, device="cuda")
    print(json.dumps({"root": root, "pack_entries_differing": {
        f: int((getattr(card, f).cpu() != getattr(host, f)).sum())
        for f in packfmt.FIELDS},
        "fake_quant_outputs_differing": fake_quants_differing(x)}),
        flush=True)
    del w, card, host, x
    if not args.patterns:
        return

    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.quantize_params_packed(
        llama.init_params(cfg, 0, torch.float32, "cuda"), cfg,
        device="cuda")

    def run(prompts, speculate):
        e = eng.Engine(params, cfg, eng.EngineConfig(
            num_slots=8, max_len=2048, seed=0), device="cuda")
        reqs = [e.submit(p, max_new_tokens=32) for p in prompts]
        if speculate:
            spec.run_spec_pipelined(e, auto_disable=False)
        else:
            e.run()
        return [list(map(int, r.generated)) for r in reqs]

    for p in range(args.patterns):
        rng = np.random.default_rng(p)
        for n in SERVE_DRAWS:
            rng.integers(0, cfg.vocab_size, n)
        pattern = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        prompts = [np.roll(np.tile(pattern, 8), i) for i in range(8)]
        got, want = run(prompts, True), run(prompts, False)
        print(json.dumps({
            "root": root, "pattern": p,
            "requests_equal_to_plain": sum(a == b for a, b in
                                           zip(got, want)),
            **chip_smoke.spec_against_decode(torch, params, cfg, prompts,
                                             got)}), flush=True)


if __name__ == "__main__":
    main()
