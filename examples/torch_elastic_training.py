"""Fault-tolerant training with the PyTorch port: checkpoint cadence,
injected node failure, elastic re-mesh, and restart-from-checkpoint (the
port of ``examples/elastic_training.py``).

  PYTHONPATH=src python examples/torch_elastic_training.py
  PYTHONPATH=src python examples/torch_elastic_training.py --device cpu

On ``cuda`` (the default) the "fleet" is the visible cards, or with
``--devices N`` N virtual devices on the first card; on ``cpu`` it is N
virtual CPU devices (default 8) running the plain versions. Each step is
the sharded train step (``distributed.sharded_train``) on a (data, 1)
mesh; half the fleet is lost at step 4, the state goes to the host and is
re-placed on the survivors' mesh, and a new runner resumes from the last
checkpoint.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import sharded_train as st
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import (ElasticRunner,
                                                     FaultInjector, reshard,
                                                     to_host)
from repro_torch.launch.train import synth_batch
from repro_torch.models import lm
from repro_torch.training import optimizer as opt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--devices", type=int, default=0,
                    help="virtual devices (default: the visible cards on "
                         "cuda, 8 on cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.devices:
        fleet = [dev] * args.devices
    elif dev.type == "cuda":
        fleet = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        fleet = [dev] * 8

    cfg = get_config("qwen3-14b").reduced().replace(remat=False)
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    rng = np.random.default_rng(0)

    def make_step(mesh):
        fsdp = mesh.shape["data"] > 1
        sf = st.make_sharded_train_step(cfg, mesh, optc=optc, ce_chunk=32)

        def step(state):
            batch = st.place_batch(synth_batch(cfg, rng, 8, 32, dev), cfg,
                                   mesh)
            params, ostate, metrics = sf(state["params"], state["opt"],
                                         batch)
            print(f"  loss={float(metrics['loss']):.4f} "
                  f"[{mesh.devices.size} devices]")
            return {"params": params, "opt": ostate}

        def shard(host):
            pspecs = shd.param_specs(host["params"], cfg, fsdp=fsdp)
            return {"params": reshard(host["params"], pspecs, mesh),
                    "opt": opt.AdamWState(
                        int(host["opt"]["step"]),
                        reshard(host["opt"]["m"], pspecs, mesh),
                        reshard(host["opt"]["v"], pspecs, mesh))}

        def unshard(state):
            return {"params": to_host(state["params"]),
                    "opt": {"step": np.asarray(state["opt"].step),
                            "m": to_host(state["opt"].m),
                            "v": to_host(state["opt"].v)}}

        return step, shard, unshard

    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    moments = opt.init_state(params)
    state0 = {"params": to_host(params),
              "opt": {"step": np.zeros((), np.int32),
                      "m": to_host(moments.m), "v": to_host(moments.v)}}
    del params, moments

    with tempfile.TemporaryDirectory() as ckdir:
        cm = CheckpointManager(ckdir, keep=2)
        injector = FaultInjector(node_loss_steps={4: max(
            1, len(fleet) // 2)})     # lose half the fleet at step 4
        runner = ElasticRunner(make_step, devices=fleet, model_parallel=1,
                               injector=injector, ckpt_manager=cm,
                               ckpt_every=3)
        print(f"starting on {runner.mesh.devices.size} devices")
        runner.run(state0, n_steps=8)
        print("failure log:", runner.log)
        assert runner.log, "the injected failure must trigger a re-mesh"

        # a full restart: a NEW runner resumes from the checkpoint
        runner2 = ElasticRunner(make_step, devices=runner.devices,
                                model_parallel=1, ckpt_manager=cm)
        step0, state = runner2.resume()
        print(f"restart: resumed from checkpoint at step {step0}")
        runner2.run(state, n_steps=2, start_step=step0)
    print("elastic training complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
