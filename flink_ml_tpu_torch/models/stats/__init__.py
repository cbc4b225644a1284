"""Statistical tests (ANOVATest, ChiSqTest, FValueTest) and the scoring
functions the feature selectors share with them.

A port of the JAX package's ``models/stats``: ChiSqTest is host work;
the ANOVA and F-regression reductions run on ``device`` (default
``"cuda"``), their p-values on the host in float64 (scipy)."""

from .anovatest import ANOVATest, anova_f_scores, f_p_values  # noqa: F401
from .chisqtest import ChiSqTest  # noqa: F401
from .fvaluetest import FValueTest, f_regression_scores  # noqa: F401
