"""Multi-device demo on the PyTorch port: the ('comp','out') mesh's sharded
loss, gradient and Adam fit, ``fit(mesh=...)`` and ``predict`` on the
('n',) mesh, n-sharded FITC and the ('comp','n') mesh, each against one
device (the steps of ``examples/multichip_sharded.py``).

The ranks are processes joined by ``torch.distributed``: by default
``n_comp * n_out`` gloo ranks that share this machine's card
(``lcgp_tpu_torch.parallel.WorkerGroup``), with ``--cpu`` on the CPU;
under ``torchrun`` one NCCL rank a card:

    python examples/torch_multichip_sharded.py [--cpu] [--n-comp 2]
        [--n-out 2] [--steps 100]
    torchrun --nproc-per-node 4 examples/torch_multichip_sharded.py
"""
from __future__ import annotations

import argparse
import os


def main(argv=None, group=None) -> dict:
    """Run the demo on every rank; prints and returns the first rank's
    summary (``lcgp_tpu_torch.parallel.tasks.multichip_demo``).  ``group``:
    an open ``WorkerGroup`` of ``n_comp * n_out`` ranks to run it on, in
    place of a new one."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='run the ranks on the CPU (default: the card)')
    ap.add_argument('--n-comp', type=int, default=2)
    ap.add_argument('--n-out', type=int, default=2)
    ap.add_argument('--steps', type=int, default=100)
    args = ap.parse_args(argv)

    from lcgp_tpu_torch.parallel import WorkerGroup, tasks

    if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        # under torchrun: this process is one rank
        import torch.distributed as dist
        from lcgp_tpu_torch.parallel import init_distributed
        dev = init_distributed(device='cpu' if args.cpu else None)
        try:
            out = tasks.multichip_demo(args.n_comp, args.n_out, args.steps,
                                       device=str(dev))
        finally:
            dist.destroy_process_group()
        if int(os.environ['RANK']) == 0:
            print('\n'.join(out['lines']))
        return out

    def run(group):
        if group.device.type == 'cuda':
            from lcgp_tpu_torch.ops._build import build
            build()     # once here, so that no rank builds the kernels
        return group.run(tasks.multichip_demo, args.n_comp, args.n_out,
                         args.steps, device=str(group.device))[0]
    if group is not None:
        out = run(group)
    else:
        with WorkerGroup(args.n_comp * args.n_out,
                         device='cpu' if args.cpu else None,
                         backend='gloo') as group:
            out = run(group)
    print('\n'.join(out['lines']))
    return out


if __name__ == '__main__':
    main()
