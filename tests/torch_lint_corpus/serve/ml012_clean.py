# Clean twin of ml012_sleep_under_lock: mutate under the lock, snapshot,
# then do the blocking work outside the critical section. The `*_locked`
# helper follows the caller-holds-the-lock naming convention.
# PINNED: no rule may fire here.
import threading


class FlushingCounter:
    def __init__(self, path):
        self._lock = threading.Lock()
        self._path = path
        self.count = 0

    def _bump_locked(self):
        self.count += 1
        return self.count

    def incr_and_flush(self):
        with self._lock:
            snapshot = self._bump_locked()
        with open(self._path, "w") as fh:
            fh.write(str(snapshot))
