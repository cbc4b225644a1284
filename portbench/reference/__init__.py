"""Plain PyTorch versions of what the benchmarked fits compute, written
from the algorithms' definitions.  They import neither the port nor JAX:
they take the host inputs and the fit's seed and work out again the init
draws, the epoch order and every round or step."""
