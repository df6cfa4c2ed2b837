# Blocking work inside a critical section: every ingest/reader thread
# contending on self._lock stalls behind the sleep and the file write.
# PINNED: ML012 must fire here (and nothing else may).
import threading
import time


class FlushingCounter:
    def __init__(self, path):
        self._lock = threading.Lock()
        self._path = path
        self.count = 0

    def incr_and_flush(self):
        with self._lock:
            self.count += 1
            time.sleep(0.05)
            with open(self._path, "w") as fh:
                fh.write(str(self.count))
