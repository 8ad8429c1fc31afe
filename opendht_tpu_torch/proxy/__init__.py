"""REST proxy subsystem.

The port's copy of the JAX package's ``proxy`` package, behaviour
unchanged: the reference's proxy pair (src/dht_proxy_server.cpp,
src/dht_proxy_client.cpp) over the port's runner.  Host code only.

- :class:`DhtProxyServer` — an HTTP facade over a running
  :class:`~opendht_tpu_torch.runtime.runner.DhtRunner`, streaming values as
  line-delimited JSON.
- :class:`DhtProxyClient` — a full ``DhtInterface``-shaped backend that
  performs get/put/listen over that REST API instead of UDP, so
  light/NAT-restricted clients can reach the DHT through one proxy node.
"""

from .json_codec import value_to_json, value_from_json
from .server import DhtProxyServer, ServerStats
from .client import DhtProxyClient

__all__ = [
    "value_to_json", "value_from_json",
    "DhtProxyServer", "ServerStats", "DhtProxyClient",
]
