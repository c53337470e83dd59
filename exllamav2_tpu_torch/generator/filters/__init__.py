from exllamav2_tpu_torch.generator.filters.base import Filter      # noqa: F401
from exllamav2_tpu_torch.generator.filters.prefix import PrefixFilter  # noqa: F401
from exllamav2_tpu_torch.generator.filters.select import SelectFilter  # noqa: F401
