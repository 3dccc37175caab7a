"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 200 [--reduced] [--device cpu] [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --debug-mesh

As the reference's launcher without ``--debug-mesh``, the model is cast to
f32, so the loop takes the ``naive`` attention path.  ``--reduced`` picks
the family-faithful small config.  ``--device`` defaults to the card and
fails without one; ``--device cpu`` runs the plain PyTorch path.

``--debug-mesh`` runs the mesh path in the config's own dtype, as the
reference's does: 4 ``gloo`` ranks on the CPU (``torch.multiprocessing``,
a ``FileStore`` in a temporary directory, every group with a timeout), a
``make_debug_mesh(4)`` (2, 2) mesh, ``assemble(..., auto_knobs=False)``
and ``train()`` given its step and the reference's batches; rank 0 prints
the ``[train]`` line.
"""
import argparse
import os
import tempfile
import time

#: the seconds a --debug-mesh run may take before its ranks are stopped
DEBUG_MESH_TIMEOUT_S = 600


def _debug_rank(rank: int, args, store: str, queue) -> None:
    """One rank of ``--debug-mesh``; rank 0 puts its losses and steps/s on
    ``queue``."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import train_batch
    from repro_torch.launch.mesh import make_debug_mesh, start_group
    from repro_torch.launch.steps import assemble
    from repro_torch.models import build_model
    from repro_torch.train import train

    torch.set_num_threads(1)
    start_group("gloo", rank, 4, store)
    try:
        cfg = (reduced_config(args.arch) if args.reduced
               else get_config(args.arch))
        tcfg = _tcfg(args)
        mesh = make_debug_mesh(4)
        shape = InputShape("debug", args.seq_len, args.batch_size, "train")
        step = assemble(cfg, shape, mesh, auto_knobs=False)
        params = step.shard_params(build_model(step.cfg).init_params(
            tcfg.seed, "cpu", trainable=True))
        res = train(step.cfg, tcfg, jit_step=step, params=params,
                    batch_fn=lambda i: train_batch(
                        step.cfg, args.batch_size, args.seq_len, seed=i,
                        device="cpu"),
                    device="cpu",
                    log_fn=print if rank == 0 else (lambda m: None))
        if rank == 0:
            queue.put((res.losses, res.steps_per_s))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _tcfg(args):
    from repro_torch.train import TrainConfig
    return TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, lr=args.lr,
                       ckpt_every=50 if args.ckpt_dir else 0,
                       ckpt_dir=args.ckpt_dir or "checkpoints")


def _debug_mesh(args):
    import torch.multiprocessing as mp

    from repro_torch.train import TrainResult

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_debug_rank,
                             args=(r, args, os.path.join(tmp, "store"),
                                   queue)) for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DEBUG_MESH_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"--debug-mesh: rank exit codes {codes}")
        losses, sps = queue.get()
    return TrainResult(losses=losses, steps_per_s=sps, final_params=None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="4 gloo ranks on the CPU, (2,2) mesh path")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.debug_mesh:
        res = _debug_mesh(args)
    else:
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.train import train

        cfg = (reduced_config(args.arch) if args.reduced
               else get_config(args.arch)).replace(dtype="float32")
        res = train(cfg, _tcfg(args), device=args.device)
    print(f"[train] {args.arch}: loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f} at {res.steps_per_s:.2f} steps/s")
    return res


if __name__ == "__main__":
    main()
