"""cfk_tpu_torch — the PyTorch + CUDA port of cfk_tpu for NVIDIA Hopper.

Block-partitioned ALS-WR collaborative filtering on Netflix-Prize-format
data (the capabilities of the Kafka-Streams reference,
trinh-hoang-hiep/Collaborative-Filtering-Kafka), ported from the JAX/TPU
package ``cfk_tpu``, which stays beside it as the reference.  Module names
mirror ``cfk_tpu``'s.  The package imports ``torch`` and numpy only — never
``jax`` and nothing of ``cfk_tpu``.

Device policy (``cfk_tpu_torch.device``): entry points run on CUDA unless the
caller passes ``device="cpu"``, and raise when CUDA is asked for and absent.
The kernels of the main path (``cfk_tpu_torch/csrc``, built with nvcc on
first use) run for CUDA tensors; their plain PyTorch versions run for CPU
tensors.
"""

from cfk_tpu_torch.config import ALSConfig
from cfk_tpu_torch.data.blocks import Dataset, IdMap, RatingsCOO
from cfk_tpu_torch.data.netflix import parse_netflix
from cfk_tpu_torch.device import resolve_device
from cfk_tpu_torch.models.als import ALSModel, train_als
from cfk_tpu_torch.weights import factors_from_numpy

__version__ = "0.1.0"

__all__ = [
    "ALSConfig",
    "ALSModel",
    "Dataset",
    "IdMap",
    "RatingsCOO",
    "factors_from_numpy",
    "parse_netflix",
    "resolve_device",
    "train_als",
    "__version__",
]
