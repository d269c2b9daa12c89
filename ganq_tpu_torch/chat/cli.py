"""Interactive chat REPL over a (quantized) checkpoint.

The port of ``ganq_tpu/chat/cli.py``: load a model directory, apply the
tokenizer's chat template and answer each turn through
``GanqModel.generate``, on the card unless ``--device cpu``.

Usage: python -m ganq_tpu_torch.chat.cli <model_dir> [--max-new-tokens N]
       [--temperature T] [--top-k K] [--system PROMPT] [--device DEV]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ganq-tpu-torch chat")
    ap.add_argument("model_dir")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--system", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ganq_tpu_torch import GanqModel

    model = GanqModel.load(args.model_dir, device=args.device)
    if model.tokenizer is None:
        print("error: no tokenizer found in model dir", file=sys.stderr)
        return 1
    tok = model.tokenizer

    messages = []
    if args.system:
        messages.append({"role": "system", "content": args.system})
    print("ganq-tpu-torch chat: empty line or /exit to quit, /reset to clear")
    while True:
        try:
            user = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not user or user == "/exit":
            break
        if user == "/reset":
            messages = messages[:1] if args.system else []
            continue
        messages.append({"role": "user", "content": user})
        if getattr(tok, "chat_template", None):
            prompt = tok.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        else:
            prompt = "\n".join(f"{m['role']}: {m['content']}"
                               for m in messages)
            prompt += "\nassistant:"
        reply = model.generate(prompt, max_new_tokens=args.max_new_tokens,
                               temperature=args.temperature, top_k=args.top_k)
        reply = reply.strip()
        print(reply)
        messages.append({"role": "assistant", "content": reply})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
