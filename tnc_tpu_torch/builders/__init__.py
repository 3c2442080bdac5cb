"""Circuit and network builders.

Imported with the package, as in the reference: ``peps``,
``random_circuit`` and ``sycamore_circuit`` are functions named like the
modules that define them, and the package attribute must be the function
whichever is imported first. None of these modules imports torch."""

from tnc_tpu_torch.builders.circuit_builder import (  # noqa: F401
    Circuit,
    Permutor,
    QuantumRegister,
    Qubit,
)
from tnc_tpu_torch.builders.connectivity import (  # noqa: F401
    Connectivity,
    ConnectivityLayout,
)
from tnc_tpu_torch.builders.peps import peps  # noqa: F401
from tnc_tpu_torch.builders.random_circuit import (  # noqa: F401
    random_circuit,
    random_circuit_with_observable,
    random_circuit_with_set_observable,
)
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit  # noqa: F401
from tnc_tpu_torch.builders.tensorgeneration import (  # noqa: F401
    random_sparse_tensor_data,
    random_sparse_tensor_data_with_rng,
)
