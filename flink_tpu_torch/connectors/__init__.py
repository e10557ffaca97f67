from .datagen import CollectionSource, DataGenSource  # noqa: F401
