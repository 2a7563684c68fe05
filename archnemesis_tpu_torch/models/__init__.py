"""Model parameterisations: importing the package registers the ported
models (0, 2, 3, 47 and 444) in ``base.MODEL_REGISTRY``."""

from archnemesis_tpu_torch.models import optics_models  # noqa: F401
from archnemesis_tpu_torch.models import profile_models  # noqa: F401
from archnemesis_tpu_torch.models.base import MODEL_REGISTRY  # noqa: F401
