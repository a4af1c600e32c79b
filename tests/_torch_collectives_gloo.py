"""One rank of ``tests/test_torch_collectives.py``'s gloo run.

``python tests/_torch_collectives_gloo.py RANK PORT DIR ARCH...``: joins a
4-rank gloo group over loopback (``tcp://127.0.0.1:PORT``), builds the
(2, 2) ``("data", "model")`` ``DeviceMesh``, waits for ``DIR/ready`` (the
test starts the ranks before it writes their inputs), and for each ARCH (a
reduced config in f32) runs ``prefill`` twice on the CPU: on the whole
parameters and tokens the test saved in DIR, and on ``DTensor``s laid out
by the dry run's specs under ``utils.collectives.count_collectives``.  It
writes ``DIR/rank<RANK>.json``: per ARCH the largest difference of the
gathered logits from the whole run's, the whole run's largest logit, and
the counter's records.  The group is destroyed whatever happens.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

torch.set_num_threads(1)


def main():
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import prefill
    from repro_torch.models.transformer import init_params
    from repro_torch.utils.collectives import (count_collectives,
                                               distribute_params, to_dtensor)

    rank, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        dm = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
        mesh = make_test_mesh((2, 2), device="meta")
        deadline = time.monotonic() + 240
        while not (out_dir / "ready").exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {out_dir / 'ready'}")
            time.sleep(0.05)
        result = {}
        for arch in sys.argv[4:]:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype="float32")
            model = init_params(None, cfg, device="meta").to_empty(
                device="cpu")
            model.load_state_dict(torch.load(out_dir / f"{arch}.pt"))
            tokens = torch.load(out_dir / f"{arch}.tokens.pt")
            with torch.no_grad():
                whole = prefill(model, cfg, tokens)[0]
                spec = specs.batch_shardings(tokens, mesh).spec
                args = (distribute_params(model, dm, mesh),
                        to_dtensor(tokens, dm, spec))
                out, counter = count_collectives(
                    lambda p, t: prefill(p, cfg, t), args, mesh)
                logits = out[0].full_tensor()
            result[arch] = {
                "err": float((logits - whole).abs().max()),
                "scale": float(whole.abs().max()),
                "records": counter.records,
            }
        (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
