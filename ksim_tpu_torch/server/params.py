"""Shared HTTP-contract constants.

The per-kind lastResourceVersion query parameters match the reference's
watcher handler (reference simulator/server/handler/watcher.go:23-46);
both the server route (server/http.py) and the built-in UI's reconnect
logic (server/ui.py) consume this one map.
"""

LRV_PARAMS = {
    "pods": "podsLastResourceVersion",
    "nodes": "nodesLastResourceVersion",
    "persistentvolumes": "pvsLastResourceVersion",
    "persistentvolumeclaims": "pvcsLastResourceVersion",
    "storageclasses": "scsLastResourceVersion",
    "priorityclasses": "pcsLastResourceVersion",
    "namespaces": "namespaceLastResourceVersion",
}
