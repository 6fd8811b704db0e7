"""Gemma causal-LM generation driver (counterpart of
``examples/gemma_generate.py``).

Random weights from ``--seed`` (each module's weights drawn from a generator
seeded by the seed and its path, ``layout.init_seeded_shard``), a prompt of
raw token ids, or text with ``--tokenizer``. ``--model_parallelism N``
splits the model over N ranks along the mesh's model axis (tensor
parallelism); launch one process a card:

  python -m iseg_tpu_torch.examples.gemma_generate --max_length 32 --temperature 0.8 --top_k 40
  torchrun --nproc_per_node=2 -m iseg_tpu_torch.examples.gemma_generate \\
      --preset gemma_7b_en --model_parallelism 2

It runs on the card unless ``--device cpu`` (gloo ranks then); every rank
computes the same tokens, and rank 0 prints them.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="gemma_test")
    p.add_argument("--prompt_ids", default="2,45,91,7",
                   help="comma-separated token ids (used when no tokenizer)")
    p.add_argument("--prompt", default=None, help="text prompt (needs --tokenizer)")
    p.add_argument("--tokenizer", default=None, help="SentencePiece model path")
    p.add_argument("--max_length", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--model_parallelism", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_lm(env, preset: str, seed: int, model_parallelism: int):
    """The generation model in fp32 on ``env``'s device, with this rank's
    shard of the seeded weights under tensor parallelism."""
    from iseg_tpu_torch.nlp.gemma import GemmaCausalLM, get_preset
    from iseg_tpu_torch.nlp.gemma.layout import init_seeded_shard
    from iseg_tpu_torch.parallel.mesh import MODEL_AXIS

    lm = GemmaCausalLM(get_preset(preset), device=env.device, mesh=env.mesh,
                       model_axis=MODEL_AXIS if model_parallelism > 1 else None)
    return init_seeded_shard(lm, seed)


def main(argv=None) -> list[int]:
    args = parse_args(argv)
    import torch

    from iseg_tpu_torch.core.env import EnvConfig, common_env_clean, common_env_setup

    distributed = args.model_parallelism > 1
    env = common_env_setup(EnvConfig(random_seed=args.seed, mixed_precision=False,
                                     device=args.device, initialize_distributed=distributed,
                                     model_parallelism=args.model_parallelism))
    try:
        lm = build_lm(env, args.preset, args.seed, args.model_parallelism)
        tokenizer = None
        if args.tokenizer:
            from iseg_tpu_torch.nlp.gemma.tokenizer import (GemmaCausalLMPreprocessor,
                                                            GemmaTokenizer)

            tokenizer = GemmaTokenizer(proto_path=args.tokenizer)
            pre = GemmaCausalLMPreprocessor(tokenizer, sequence_length=args.max_length)
            ids, lengths = pre([args.prompt or "Hello"], for_generation=True)
            prompt = torch.as_tensor(ids[:, :int(lengths[0])])
        else:
            prompt = torch.tensor([[int(t) for t in args.prompt_ids.split(",")]])
        lengths = torch.tensor([prompt.shape[1]])
        out = lm.generate(prompt, lengths, max_length=args.max_length,
                          temperature=args.temperature, top_k=args.top_k,
                          generator=torch.Generator(device=lm.device).manual_seed(args.seed),
                          end_token_id=tokenizer.eos_id if tokenizer else None)
        ids = out[0].cpu().tolist()
        if env.rank == 0:
            print("generated ids:", ids)
            if tokenizer:
                # bos/eos/pad are stripped before detokenizing
                print("text:", GemmaCausalLMPreprocessor(tokenizer).generate_postprocess(
                    out[:1].cpu().numpy())[0])
        return ids
    finally:
        common_env_clean(env)


if __name__ == "__main__":
    main()
