"""Hand-written CUDA kernels of the port and their wrappers.

``launch_counts`` counts, per kernel name, the launches each wrapper made
on the card. A wrapper adds one where it launches its kernel and nowhere
else; on a CPU tensor it runs the kernel's plain PyTorch version and
counts nothing. Wrappers called from several threads (FleetExecutor's
interceptors) count under ``count_lock``.
"""
import threading
from collections import Counter

launch_counts: Counter = Counter()
count_lock = threading.Lock()
