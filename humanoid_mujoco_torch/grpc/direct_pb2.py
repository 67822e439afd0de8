# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: direct.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x64irect.proto\x12\x1ahumanoid_mujoco_tpu.direct\"\x07\n\x05\x45mpty\"H\n\x0bInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x1c\n\x14\x63onfiguration_length\x18\x02 \x01(\x05\x12\n\n\x02\x64t\x18\x03 \x01(\x01\"E\n\x0b\x44\x61taRequest\x12\x10\n\x04qpos\x18\x01 \x03(\x01\x42\x02\x10\x01\x12\x12\n\x06sensor\x18\x02 \x03(\x01\x42\x02\x10\x01\x12\x10\n\x04\x63trl\x18\x03 \x03(\x01\x42\x02\x10\x01\"\x81\x01\n\x0fSettingsRequest\x12\x10\n\x08gn_iters\x18\x01 \x01(\x05\x12\x15\n\restimate_mass\x18\x02 \x01(\x08\x12\x14\n\x0c\x66orce_weight\x18\x03 \x01(\x01\x12\x16\n\x0eregularization\x18\x04 \x01(\x01\x12\x17\n\x0f\x65stimate_params\x18\x05 \x03(\t\"\x82\x01\n\x10SettingsResponse\x12\x10\n\x08gn_iters\x18\x01 \x01(\x05\x12\x15\n\restimate_mass\x18\x02 \x01(\x08\x12\x14\n\x0c\x66orce_weight\x18\x03 \x01(\x01\x12\x16\n\x0eregularization\x18\x04 \x01(\x01\x12\x17\n\x0f\x65stimate_params\x18\x05 \x03(\t\"\x8c\x01\n\x10OptimizeResponse\x12\x14\n\x0c\x63ost_initial\x18\x01 \x01(\x01\x12\x12\n\ncost_final\x18\x02 \x01(\x01\x12\x12\n\nmass_scale\x18\x03 \x01(\x01\x12\x16\n\nparameters\x18\x04 \x03(\x01\x42\x02\x10\x01\x12\x10\n\x04qpos\x18\x05 \x03(\x01\x42\x02\x10\x01\x12\x10\n\x04qvel\x18\x06 \x03(\x01\x42\x02\x10\x01\"\x1d\n\x0c\x43ostResponse\x12\r\n\x05total\x18\x01 \x01(\x01\"C\n\x0eStatusResponse\x12\x10\n\x08gn_iters\x18\x01 \x01(\x05\x12\x0c\n\x04\x63ost\x18\x02 \x01(\x01\x12\x11\n\toptimized\x18\x03 \x01(\x08\x32\xf1\x04\n\x06\x44irect\x12R\n\x04Init\x12\'.humanoid_mujoco_tpu.direct.InitRequest\x1a!.humanoid_mujoco_tpu.direct.Empty\x12R\n\x04\x44\x61ta\x12\'.humanoid_mujoco_tpu.direct.DataRequest\x1a!.humanoid_mujoco_tpu.direct.Empty\x12\x65\n\x08Settings\x12+.humanoid_mujoco_tpu.direct.SettingsRequest\x1a,.humanoid_mujoco_tpu.direct.SettingsResponse\x12[\n\x08Optimize\x12!.humanoid_mujoco_tpu.direct.Empty\x1a,.humanoid_mujoco_tpu.direct.OptimizeResponse\x12S\n\x04\x43ost\x12!.humanoid_mujoco_tpu.direct.Empty\x1a(.humanoid_mujoco_tpu.direct.CostResponse\x12W\n\x06Status\x12!.humanoid_mujoco_tpu.direct.Empty\x1a*.humanoid_mujoco_tpu.direct.StatusResponse\x12M\n\x05Reset\x12!.humanoid_mujoco_tpu.direct.Empty\x1a!.humanoid_mujoco_tpu.direct.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'direct_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DATAREQUEST.fields_by_name['qpos']._options = None
  _DATAREQUEST.fields_by_name['qpos']._serialized_options = b'\020\001'
  _DATAREQUEST.fields_by_name['sensor']._options = None
  _DATAREQUEST.fields_by_name['sensor']._serialized_options = b'\020\001'
  _DATAREQUEST.fields_by_name['ctrl']._options = None
  _DATAREQUEST.fields_by_name['ctrl']._serialized_options = b'\020\001'
  _OPTIMIZERESPONSE.fields_by_name['parameters']._options = None
  _OPTIMIZERESPONSE.fields_by_name['parameters']._serialized_options = b'\020\001'
  _OPTIMIZERESPONSE.fields_by_name['qpos']._options = None
  _OPTIMIZERESPONSE.fields_by_name['qpos']._serialized_options = b'\020\001'
  _OPTIMIZERESPONSE.fields_by_name['qvel']._options = None
  _OPTIMIZERESPONSE.fields_by_name['qvel']._serialized_options = b'\020\001'
  _EMPTY._serialized_start=44
  _EMPTY._serialized_end=51
  _INITREQUEST._serialized_start=53
  _INITREQUEST._serialized_end=125
  _DATAREQUEST._serialized_start=127
  _DATAREQUEST._serialized_end=196
  _SETTINGSREQUEST._serialized_start=199
  _SETTINGSREQUEST._serialized_end=328
  _SETTINGSRESPONSE._serialized_start=331
  _SETTINGSRESPONSE._serialized_end=461
  _OPTIMIZERESPONSE._serialized_start=464
  _OPTIMIZERESPONSE._serialized_end=604
  _COSTRESPONSE._serialized_start=606
  _COSTRESPONSE._serialized_end=635
  _STATUSRESPONSE._serialized_start=637
  _STATUSRESPONSE._serialized_end=704
  _DIRECT._serialized_start=707
  _DIRECT._serialized_end=1332
# @@protoc_insertion_point(module_scope)
