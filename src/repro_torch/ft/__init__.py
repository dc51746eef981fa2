from .runtime import (FaultTolerantLoop, HeartbeatMonitor,  # noqa: F401
                      Snapshotter, StragglerTracker)
