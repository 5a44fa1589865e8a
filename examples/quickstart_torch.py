"""Quickstart on the PyTorch port: train a tiny LM and greedy-decode —
the sibling of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import DataConfig, global_batch_at
from repro_torch.launch.train import make_trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = reduced(get_config("minitron-4b"), d_model=64, vocab=64,
                  n_layers=2, attn_chunk=32)
    run_step, state, api, _rules = make_trainer(
        cfg, global_batch=8, seq_len=64, peak_lr=3e-3, total_steps=40,
        device=args.device)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    dev = state.params["embed"].device

    print(f"training {cfg.name} (reduced) on {dev}")
    for step in range(40):
        state, metrics = run_step(state, global_batch_at(dc, step))
        if step % 10 == 0 or step == 39:
            print(f"  step {step:3d}  loss {float(metrics['loss']):.4f}")

    # greedy decode a continuation
    prompt = global_batch_at(dc, 999)["tokens"][:2, :16].to(dev)
    with torch.no_grad():
        logits, caches = api.prefill(state.params, {"tokens": prompt},
                                     max_seq=32)
        toks = [int(torch.argmax(logits[0]))]
        for i in range(8):
            logits, caches = api.decode_step(
                state.params, caches,
                torch.tensor([[toks[-1]], [toks[-1]]], device=dev), 16 + i)
            toks.append(int(torch.argmax(logits[0])))
    print("greedy continuation:", toks)
    # the synthetic corpus follows t' = 31t+7 mod V most of the time —
    # a trained model should have picked that up for some steps
    follows = sum((toks[i + 1] == (toks[i] * 31 + 7) % cfg.vocab)
                  for i in range(len(toks) - 1))
    print(f"markov-rule hits: {follows}/{len(toks) - 1}")
    return follows


if __name__ == "__main__":
    main()
