"""Feature stages (all of the JAX package's ``models/feature``)."""

from .encoders import (  # noqa: F401
    OneHotEncoder,
    OneHotEncoderModel,
    StringIndexer,
    StringIndexerModel,
    VectorAssembler,
)
from .lsh import (  # noqa: F401
    MinHashLSH,
    MinHashLSHModel,
)
from .online_scaler import (  # noqa: F401
    OnlineStandardScaler,
    OnlineStandardScalerModel,
)
from .pca import PCA, PCAModel  # noqa: F401
from .randomsplitter import RandomSplitter  # noqa: F401
from .scalers import (  # noqa: F401
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from .selectors import (  # noqa: F401
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from .sqltransformer import SQLTransformer  # noqa: F401
from .text import (  # noqa: F401
    FeatureHasher,
    HashingTF,
    IDF,
    IDFModel,
    IndexToString,
)
from .tokenize import (  # noqa: F401
    CountVectorizer,
    CountVectorizerModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from .transforms import (  # noqa: F401
    Binarizer,
    Bucketizer,
    Imputer,
    ImputerModel,
    Normalizer,
    PolynomialExpansion,
)
from .vector_ops import (  # noqa: F401
    DCT,
    ElementwiseProduct,
    Interaction,
    KBinsDiscretizer,
    KBinsDiscretizerModel,
    VectorIndexer,
    VectorIndexerModel,
    VectorSlicer,
)
