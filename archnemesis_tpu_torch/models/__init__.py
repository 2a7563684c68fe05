"""Model parameterisations: importing the package registers the ported
models in ``base.MODEL_REGISTRY``: -1, 0, 1, 2, 3, 4, 9, 20, 32, 43, 45,
47, 49, 50, 51, 62, 110, 111 and 1002 (``profile_models``); 228, 229, 230, 231,
232, 233, 447, 555, 556, 666, 667, 777, 887 and 999 (``domain_models``);
202, 444, 446 and 500 (``optics_models``): all 37 of the JAX package's ids."""

from archnemesis_tpu_torch.models import domain_models  # noqa: F401
from archnemesis_tpu_torch.models import optics_models  # noqa: F401
from archnemesis_tpu_torch.models import profile_models  # noqa: F401
from archnemesis_tpu_torch.models.base import MODEL_REGISTRY  # noqa: F401
