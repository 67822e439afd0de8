# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filter.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x66ilter.proto\x12\x1ahumanoid_mujoco_tpu.filter\"\x07\n\x05\x45mpty\":\n\x0bInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0c\n\x04qpos\x18\x02 \x03(\x01\x12\x0c\n\x04qvel\x18\x03 \x03(\x01\"5\n\rUpdateRequest\x12\x10\n\x04\x63trl\x18\x01 \x03(\x01\x42\x02\x10\x01\x12\x12\n\x06sensor\x18\x02 \x03(\x01\x42\x02\x10\x01\"$\n\x0eUpdateResponse\x12\x12\n\ninnovation\x18\x01 \x01(\x01\"3\n\rStateResponse\x12\x10\n\x04qpos\x18\x01 \x03(\x01\x42\x02\x10\x01\x12\x10\n\x04qvel\x18\x02 \x03(\x01\x42\x02\x10\x01\"?\n\x12\x43ovarianceResponse\x12\x11\n\tdimension\x18\x01 \x01(\x05\x12\x16\n\ncovariance\x18\x02 \x03(\x01\x42\x02\x10\x01\"#\n\rNoiseResponse\x12\x12\n\x06sensor\x18\x01 \x03(\x01\x42\x02\x10\x01\x32\xa4\x04\n\x0fStateEstimation\x12R\n\x04Init\x12\'.humanoid_mujoco_tpu.filter.InitRequest\x1a!.humanoid_mujoco_tpu.filter.Empty\x12M\n\x05Reset\x12!.humanoid_mujoco_tpu.filter.Empty\x1a!.humanoid_mujoco_tpu.filter.Empty\x12_\n\x06Update\x12).humanoid_mujoco_tpu.filter.UpdateRequest\x1a*.humanoid_mujoco_tpu.filter.UpdateResponse\x12U\n\x05State\x12!.humanoid_mujoco_tpu.filter.Empty\x1a).humanoid_mujoco_tpu.filter.StateResponse\x12_\n\nCovariance\x12!.humanoid_mujoco_tpu.filter.Empty\x1a..humanoid_mujoco_tpu.filter.CovarianceResponse\x12U\n\x05Noise\x12!.humanoid_mujoco_tpu.filter.Empty\x1a).humanoid_mujoco_tpu.filter.NoiseResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filter_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _UPDATEREQUEST.fields_by_name['ctrl']._options = None
  _UPDATEREQUEST.fields_by_name['ctrl']._serialized_options = b'\020\001'
  _UPDATEREQUEST.fields_by_name['sensor']._options = None
  _UPDATEREQUEST.fields_by_name['sensor']._serialized_options = b'\020\001'
  _STATERESPONSE.fields_by_name['qpos']._options = None
  _STATERESPONSE.fields_by_name['qpos']._serialized_options = b'\020\001'
  _STATERESPONSE.fields_by_name['qvel']._options = None
  _STATERESPONSE.fields_by_name['qvel']._serialized_options = b'\020\001'
  _COVARIANCERESPONSE.fields_by_name['covariance']._options = None
  _COVARIANCERESPONSE.fields_by_name['covariance']._serialized_options = b'\020\001'
  _NOISERESPONSE.fields_by_name['sensor']._options = None
  _NOISERESPONSE.fields_by_name['sensor']._serialized_options = b'\020\001'
  _EMPTY._serialized_start=44
  _EMPTY._serialized_end=51
  _INITREQUEST._serialized_start=53
  _INITREQUEST._serialized_end=111
  _UPDATEREQUEST._serialized_start=113
  _UPDATEREQUEST._serialized_end=166
  _UPDATERESPONSE._serialized_start=168
  _UPDATERESPONSE._serialized_end=204
  _STATERESPONSE._serialized_start=206
  _STATERESPONSE._serialized_end=257
  _COVARIANCERESPONSE._serialized_start=259
  _COVARIANCERESPONSE._serialized_end=322
  _NOISERESPONSE._serialized_start=324
  _NOISERESPONSE._serialized_end=359
  _STATEESTIMATION._serialized_start=362
  _STATEESTIMATION._serialized_end=910
# @@protoc_insertion_point(module_scope)
