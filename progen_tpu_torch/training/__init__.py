from progen_tpu_torch.telemetry.stitch import emit_clock_beacon

# The step-boundary clock-beacon contract lives with training: the train
# loop calls ``emit_clock_beacon(step)`` once per optimizer step, right
# after the host sync that observes the step's collective result (the
# loss fetch behind the gradient all-reduce). Every rank crosses that
# barrier at the same moment, so the beacons are the shared reference
# event ``telemetry.stitch`` aligns per-process clocks on when it merges
# a fleet's event files.

__all__ = ["emit_clock_beacon"]
