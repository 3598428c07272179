"""Generated protobuf modules (protoc --python_out; service handlers are
hand-written in kubebrain_tpu_torch.server since grpc_tools is not
available).

Their source is ``kubebrain_tpu/proto/*.proto``, the one copy of the
schema: these files are the JAX package's generated ones. protoc emits
flat sibling imports (``import kv_pb2``); ``rpc_pb2.py`` here imports
package-relatively (``from . import kv_pb2``), a hand edit to keep when the
files are regenerated, so these modules never resolve to another package's
copies through ``sys.path``. Each file registers the
same descriptors as ``kubebrain_tpu/proto``; the default descriptor pool
accepts the identical second registration and both packages share one set
of message classes.
"""

from . import brain_pb2, health_pb2, kv_pb2, rpc_pb2

__all__ = ["kv_pb2", "rpc_pb2", "brain_pb2", "health_pb2"]
