"""The port's serve CLI, SIGKILLed by itself at the start of its N-th
scheduler step (before that step's decode and journal writes), as a
process dies mid-stream:

    python tests/torch_serve_child.py N [serve flags]

Imports torch's side only."""

import os
import signal
import sys

from progen_tpu_torch.cli import serve
from progen_tpu_torch.serving.scheduler import Scheduler


def main() -> None:
    kill_at, argv = int(sys.argv[1]), sys.argv[2:]
    step, calls = Scheduler.step, [0]

    def dying_step(self):
        calls[0] += 1
        if calls[0] == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        return step(self)

    Scheduler.step = dying_step
    serve.main(argv)


if __name__ == "__main__":
    main()
