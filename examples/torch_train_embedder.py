"""Train the ALBERT-style sentence embedder with a contrastive objective,
with the PyTorch port (the port of ``examples/train_embedder.py``).

  PYTHONPATH=src python examples/torch_train_embedder.py             # cuda
  PYTHONPATH=src python examples/torch_train_embedder.py --steps 60  # quick look
  PYTHONPATH=src python examples/torch_train_embedder.py --device cpu

Synthetic paraphrase corpus: "topics" are word pools; two samples of the
same topic are positives (in-batch negatives, InfoNCE / multiple-negatives
ranking loss, the sentence-transformers recipe). After a few dozen steps
the dup/non-dup similarity gap turns positive, the property Table 1
selects embedders by. The reduced embedder in f32, as the reference's
example; the step is ``repro_torch.launch.train_embedder``'s. On
``cuda`` the attention is the f32 K4 and its backward the f32 one-pass
kernel; the last line gives their launches.
"""
import argparse
import json

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train_embedder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    f = fa_ops.flash_attention
    f32, one = f.launches_f32, f.launches_bwd_f32_one_pass
    res = train_embedder.train(args.steps, args.batch, args.lr, args.seed,
                               device=args.device)
    (d0, n0), (d1, n1) = res["before"], res["after"]
    assert d1 - n1 > d0 - n0, "training must widen the dup/non-dup gap"
    print("gap widened — embedder learned paraphrase similarity.")
    print("kernel launches: " + json.dumps(
        {"flash_attention_f32": f.launches_f32 - f32,
         "flash_attention_bwd_f32_one_pass":
             f.launches_bwd_f32_one_pass - one}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
