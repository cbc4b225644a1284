from .param import *  # noqa: F401,F403
from .with_params import WithParams  # noqa: F401
from .shared import *  # noqa: F401,F403
