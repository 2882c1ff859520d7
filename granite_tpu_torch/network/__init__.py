from .netfs import NetfsBackend, NetfsServer
