# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: brain.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x62rain.proto\x12\x07\x62rainpb\"=\n\rBrainKeyValue\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\x10\n\x08revision\x18\x03 \x01(\x04\"\x80\x01\n\nBrainEvent\x12%\n\x04type\x18\x01 \x01(\x0e\x32\x17.brainpb.BrainEventType\x12\x10\n\x08revision\x18\x02 \x01(\x04\x12\"\n\x02kv\x18\x03 \x01(\x0b\x32\x16.brainpb.BrainKeyValue\x12\x15\n\rprev_revision\x18\x04 \x01(\x04\"+\n\rCreateRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"5\n\x0e\x43reateResponse\x12\x11\n\tsucceeded\x18\x01 \x01(\x08\x12\x10\n\x08revision\x18\x02 \x01(\x04\"F\n\rUpdateRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\x19\n\x11\x65xpected_revision\x18\x03 \x01(\x04\"]\n\x0eUpdateResponse\x12\x11\n\tsucceeded\x18\x01 \x01(\x08\x12\x10\n\x08revision\x18\x02 \x01(\x04\x12&\n\x06latest\x18\x03 \x01(\x0b\x32\x16.brainpb.BrainKeyValue\"<\n\x12\x42rainDeleteRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x19\n\x11\x65xpected_revision\x18\x02 \x01(\x04\"c\n\x13\x42rainDeleteResponse\x12\x11\n\tsucceeded\x18\x01 \x01(\x08\x12\x10\n\x08revision\x18\x02 \x01(\x04\x12\'\n\x07prev_kv\x18\x03 \x01(\x0b\x32\x16.brainpb.BrainKeyValue\"\'\n\x13\x42rainCompactRequest\x12\x10\n\x08revision\x18\x01 \x01(\x04\"2\n\x14\x42rainCompactResponse\x12\x1a\n\x12\x63ompacted_revision\x18\x01 \x01(\x04\"+\n\nGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x10\n\x08revision\x18\x02 \x01(\x04\"J\n\x0bGetResponse\x12\"\n\x02kv\x18\x01 \x01(\x0b\x32\x16.brainpb.BrainKeyValue\x12\x17\n\x0fheader_revision\x18\x02 \x01(\x04\"P\n\x11\x42rainRangeRequest\x12\r\n\x05start\x18\x01 \x01(\x0c\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x0c\x12\x10\n\x08revision\x18\x03 \x01(\x04\x12\r\n\x05limit\x18\x04 \x01(\x03\"`\n\x12\x42rainRangeResponse\x12#\n\x03kvs\x18\x01 \x03(\x0b\x32\x16.brainpb.BrainKeyValue\x12\x0c\n\x04more\x18\x02 \x01(\x08\x12\x17\n\x0fheader_revision\x18\x03 \x01(\x04\"*\n\x0c\x43ountRequest\x12\r\n\x05start\x18\x01 \x01(\x0c\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x0c\"7\n\rCountResponse\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x17\n\x0fheader_revision\x18\x02 \x01(\x04\"2\n\x14ListPartitionRequest\x12\r\n\x05start\x18\x01 \x01(\x0c\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x0c\"A\n\x15ListPartitionResponse\x12\x0f\n\x07\x62orders\x18\x01 \x03(\x0c\x12\x17\n\x0fheader_revision\x18\x02 \x01(\x04\";\n\x11\x42rainWatchRequest\x12\x0e\n\x06prefix\x18\x01 \x01(\x0c\x12\x16\n\x0estart_revision\x18\x02 \x01(\x04\"c\n\x12\x42rainWatchResponse\x12#\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x13.brainpb.BrainEvent\x12\x0f\n\x07\x65xpired\x18\x02 \x01(\x08\x12\x17\n\x0fheader_revision\x18\x03 \x01(\x04*1\n\x0e\x42rainEventType\x12\n\n\x06\x43REATE\x10\x00\x12\x07\n\x03PUT\x10\x01\x12\n\n\x06\x44\x45LETE\x10\x02\x32\x94\x05\n\x05\x42rain\x12\x39\n\x06\x43reate\x12\x16.brainpb.CreateRequest\x1a\x17.brainpb.CreateResponse\x12\x39\n\x06Update\x12\x16.brainpb.UpdateRequest\x1a\x17.brainpb.UpdateResponse\x12\x43\n\x06\x44\x65lete\x12\x1b.brainpb.BrainDeleteRequest\x1a\x1c.brainpb.BrainDeleteResponse\x12\x46\n\x07\x43ompact\x12\x1c.brainpb.BrainCompactRequest\x1a\x1d.brainpb.BrainCompactResponse\x12\x30\n\x03Get\x12\x13.brainpb.GetRequest\x1a\x14.brainpb.GetResponse\x12@\n\x05Range\x12\x1a.brainpb.BrainRangeRequest\x1a\x1b.brainpb.BrainRangeResponse\x12H\n\x0bRangeStream\x12\x1a.brainpb.BrainRangeRequest\x1a\x1b.brainpb.BrainRangeResponse0\x01\x12\x36\n\x05\x43ount\x12\x15.brainpb.CountRequest\x1a\x16.brainpb.CountResponse\x12N\n\rListPartition\x12\x1d.brainpb.ListPartitionRequest\x1a\x1e.brainpb.ListPartitionResponse\x12\x42\n\x05Watch\x12\x1a.brainpb.BrainWatchRequest\x1a\x1b.brainpb.BrainWatchResponse0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'brain_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BRAINEVENTTYPE._serialized_start=1424
  _BRAINEVENTTYPE._serialized_end=1473
  _BRAINKEYVALUE._serialized_start=24
  _BRAINKEYVALUE._serialized_end=85
  _BRAINEVENT._serialized_start=88
  _BRAINEVENT._serialized_end=216
  _CREATEREQUEST._serialized_start=218
  _CREATEREQUEST._serialized_end=261
  _CREATERESPONSE._serialized_start=263
  _CREATERESPONSE._serialized_end=316
  _UPDATEREQUEST._serialized_start=318
  _UPDATEREQUEST._serialized_end=388
  _UPDATERESPONSE._serialized_start=390
  _UPDATERESPONSE._serialized_end=483
  _BRAINDELETEREQUEST._serialized_start=485
  _BRAINDELETEREQUEST._serialized_end=545
  _BRAINDELETERESPONSE._serialized_start=547
  _BRAINDELETERESPONSE._serialized_end=646
  _BRAINCOMPACTREQUEST._serialized_start=648
  _BRAINCOMPACTREQUEST._serialized_end=687
  _BRAINCOMPACTRESPONSE._serialized_start=689
  _BRAINCOMPACTRESPONSE._serialized_end=739
  _GETREQUEST._serialized_start=741
  _GETREQUEST._serialized_end=784
  _GETRESPONSE._serialized_start=786
  _GETRESPONSE._serialized_end=860
  _BRAINRANGEREQUEST._serialized_start=862
  _BRAINRANGEREQUEST._serialized_end=942
  _BRAINRANGERESPONSE._serialized_start=944
  _BRAINRANGERESPONSE._serialized_end=1040
  _COUNTREQUEST._serialized_start=1042
  _COUNTREQUEST._serialized_end=1084
  _COUNTRESPONSE._serialized_start=1086
  _COUNTRESPONSE._serialized_end=1141
  _LISTPARTITIONREQUEST._serialized_start=1143
  _LISTPARTITIONREQUEST._serialized_end=1193
  _LISTPARTITIONRESPONSE._serialized_start=1195
  _LISTPARTITIONRESPONSE._serialized_end=1260
  _BRAINWATCHREQUEST._serialized_start=1262
  _BRAINWATCHREQUEST._serialized_end=1321
  _BRAINWATCHRESPONSE._serialized_start=1323
  _BRAINWATCHRESPONSE._serialized_end=1422
  _BRAIN._serialized_start=1476
  _BRAIN._serialized_end=2136
# @@protoc_insertion_point(module_scope)
