"""One rank of a world: ``python -m repro_torch.runtime <spec> <rank>``
(started by ``runtime.world.run_world``)."""
import sys

from .world import _rank_main

sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
