"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 200 [--reduced] [--device cpu] [--ckpt-dir DIR]

As the reference's launcher without ``--debug-mesh``, the model is cast to
f32, so the loop takes the ``naive`` attention path.  ``--reduced`` picks
the family-faithful small config.  ``--device`` defaults to the card and
fails without one; ``--device cpu`` runs the plain PyTorch path.
``--debug-mesh`` (the reference's pjit path on a device mesh) raises: the
mesh waits for ROADMAP.md §1 item 9 step 2b.
"""
import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="the reference's (2,2) mesh pjit path; not ported")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.debug_mesh:
        raise NotImplementedError(
            "--debug-mesh: the device mesh waits for ROADMAP.md §1 item 9 "
            "step 2b")

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.train import TrainConfig, train

    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch)).replace(dtype="float32")
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, lr=args.lr,
                       ckpt_every=50 if args.ckpt_dir else 0,
                       ckpt_dir=args.ckpt_dir or "checkpoints")
    res = train(cfg, tcfg, device=args.device)
    print(f"[train] {args.arch}: loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f} at {res.steps_per_s:.2f} steps/s")
    return res


if __name__ == "__main__":
    main()
