from .agglomerative import AgglomerativeClustering  # noqa: F401
from .kmeans import KMeans, KMeansModel  # noqa: F401
from .online_kmeans import OnlineKMeans, OnlineKMeansModel  # noqa: F401
