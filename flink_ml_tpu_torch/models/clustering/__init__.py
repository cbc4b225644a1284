from .kmeans import KMeans, KMeansModel  # noqa: F401
