from .vfs import Filesystem, FilesystemBackend, OSFilesystem, MemoryBackend
from .asset_manager import AssetManager, AssetClass, AssetID
