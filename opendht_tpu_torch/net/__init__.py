"""L1 — host network engine: the msgpack wire protocol and request
lifecycle of the DHT (reference src/network_engine.cpp et al.), kept
transport-agnostic: the engine serializes/parses packets and manages
retries/fragmentation/rate limits; actual datagram IO is a callable
injected by the runtime (a UDP socket, or a test harness wiring two
engines back-to-back).

The port of the JAX package's ``net`` package: its modules are copies
with their behaviour unchanged, encoding through the port's own msgpack
codec.
"""

from .node import Node, Socket, NODE_GOOD_TIME, NODE_EXPIRE_TIME, MAX_RESPONSE_TIME  # noqa: F401
from .node_cache import NodeCache  # noqa: F401
from .request import Request, RequestState, MAX_ATTEMPT_COUNT  # noqa: F401
from .parsed_message import MessageType, ParsedMessage  # noqa: F401
from .engine import (  # noqa: F401
    DhtProtocolException, EngineCallbacks, NetworkEngine, RequestAnswer,
)
