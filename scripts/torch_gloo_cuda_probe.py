"""Which gloo collectives take CUDA tensors: one of two ranks on one card.

The port's gloo route hands CUDA tensors to gloo as they are
(``parallel/collectives.py`` ``PackedAxis``). This probe calls
``all_reduce``, ``all_gather`` and ``broadcast`` of the gloo backend on
tensors of ``DEVICE`` and records, per collective, whether the call ran and
gave the expected result; rank 0 writes the record as JSON.

    python scripts/torch_gloo_cuda_probe.py RANK PORT OUT.json [DEVICE]

Both ranks take the same ``PORT`` (rank 0 hosts the store on 127.0.0.1).
"""

from __future__ import annotations

import datetime
import json
import sys

import torch
import torch.distributed as dist


def main(argv: list[str]) -> int:
    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    device = torch.device(argv[3] if len(argv) > 3 else "cuda:0")
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    base = torch.arange(8, dtype=torch.float32) + 10 * rank
    want = {"all_reduce": torch.arange(8, dtype=torch.float32) * 2 + 10,
            "all_gather": torch.cat([torch.arange(8, dtype=torch.float32) + 10 * r
                                     for r in range(2)]),
            "broadcast": torch.arange(8, dtype=torch.float32)}

    def all_reduce(x):
        dist.all_reduce(x)
        return x

    def all_gather(x):
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def broadcast(x):
        dist.broadcast(x, src=0)
        return x

    record = {"device": str(device), "torch": torch.__version__}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("broadcast", broadcast)):
        try:
            got = fn(base.clone().to(device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            record[name] = {"ran": True, "equal": bool(torch.equal(got.cpu(), want[name])),
                            "error": None}
        except RuntimeError as e:  # the backend refusing the device is the finding
            record[name] = {"ran": False, "equal": False, "error": str(e)[:300]}
        dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(record, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
