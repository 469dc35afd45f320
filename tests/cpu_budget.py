"""The CPU budget of the port's slowest test modules: `module_budget` runs
a module with torch on one intra-op thread. Their models are tiny and gain
nothing from more threads, while the suite's parallel workers share the
machine's cores: a worker's torch taking every core slows every other
worker's tests. The previous thread count comes back when the module
ends."""

import torch


def module_budget():
    """A generator for a module-scoped autouse fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
