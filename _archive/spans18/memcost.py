"""Host cost of reading the allocator's live bytes on the card, three
ways, with some tensors allocated."""
import time

import torch

dev = torch.device("cuda", 0)
keep = [torch.empty(1 << k, device=dev) for k in range(10, 24)]
n = 3000
ways = {
    "memory_allocated": lambda: torch.cuda.memory_allocated(dev),
    "nested_dict": lambda: torch.cuda.memory_stats_as_nested_dict(dev)[
        "allocated_bytes"]["all"]["current"],
}
for rep in range(2):
    for name, fn in ways.items():
        t = time.perf_counter()
        for _ in range(n):
            v = fn()
        print(f"{name}: {(time.perf_counter() - t) / n * 1e6:.2f} us, "
              f"value {v}", flush=True)
