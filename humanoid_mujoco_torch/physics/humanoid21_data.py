"""Numeric tables of the upstream MJPC humanoid (21 actuated DOF).

The port's own copy of humanoid_mujoco_tpu/physics/humanoid21_data.py:
the dm_control humanoid with MJPC's modifications
(mjpc/tasks/humanoid/humanoid.xml.patch), compiled once with MuJoCo
and recorded as plain data: body inertials (MJCF computes them from geom
density 1000), joint, geom and site frames, actuator gears and the
fixed-tendon ranges. physics/humanoid_upstream.py builds the model from
them.
"""

BODIES = [{'name': 'torso', 'parent': -1, 'pos': (0.0, 0.0, 1.282), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 5.853834311, 'ipos': (-0.003864043, 0.0, -0.046368515), 'iquat': (0.999136066, 0.0, 0.041558644, 0.0), 'inertia': (0.051274193, 0.03196675, 0.031149341)},
 {'name': 'head', 'parent': 0, 'pos': (0.0, 0.0, 0.19), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 3.053628059, 'ipos': (0.0, 0.0, 0.0), 'iquat': (1.0, 0.0, 0.0, 0.0), 'inertia': (0.009893755, 0.009893755, 0.009893755)},
 {'name': 'waist_lower', 'parent': 0, 'pos': (-0.01, 0.0, -0.26), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 2.261946711, 'ipos': (0.0, 0.0, 0.0), 'iquat': (0.707106781, 0.707106781, 0.0, -0.0), 'inertia': (0.00985304, 0.00985304, 0.003745784)},
 {'name': 'pelvis', 'parent': 2, 'pos': (0.0, 0.0, -0.165), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 6.616194128, 'ipos': (-0.02, 0.0, 0.0), 'iquat': (0.707106781, 0.707106781, 0.0, -0.0), 'inertia': (0.052317979, 0.052317979, 0.024322147)},
 {'name': 'thigh_right', 'parent': 3, 'pos': (0.0, -0.1, -0.04), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 4.751750929, 'ipos': (0.0, 0.005, -0.17), 'iquat': (0.999891933, 0.014701115, 0.0, -0.0), 'inertia': (0.074951654, 0.074951654, 0.008227431)},
 {'name': 'shin_right', 'parent': 4, 'pos': (0.0, 0.01, -0.4), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 2.755696167, 'ipos': (0.0, 0.0, -0.15), 'iquat': (1.0, 0.0, 0.0, 0.0), 'inertia': (0.032608015, 0.032608015, 0.00318989)},
 {'name': 'foot_right', 'parent': 5, 'pos': (0.0, 0.0, -0.39), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 1.131141232, 'ipos': (0.035, 0.0, 0.0), 'iquat': (0.0, 0.707106781, 0.0, 0.707106781), 'inertia': (0.006446462, 0.005943724, 0.000903017)},
 {'name': 'thigh_left', 'parent': 3, 'pos': (0.0, 0.1, -0.04), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 4.751750929, 'ipos': (0.0, -0.005, -0.17), 'iquat': (0.999891933, -0.014701115, 0.0, 0.0), 'inertia': (0.074951654, 0.074951654, 0.008227431)},
 {'name': 'shin_left', 'parent': 7, 'pos': (0.0, -0.01, -0.4), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 2.755696167, 'ipos': (0.0, 0.0, -0.15), 'iquat': (1.0, 0.0, 0.0, 0.0), 'inertia': (0.032608015, 0.032608015, 0.00318989)},
 {'name': 'foot_left', 'parent': 8, 'pos': (0.0, 0.0, -0.39), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 1.131141232, 'ipos': (0.035, 0.0, 0.0), 'iquat': (0.0, 0.707106781, 0.0, 0.707106781), 'inertia': (0.006446462, 0.005943724, 0.000903017)},
 {'name': 'upper_arm_right', 'parent': 0, 'pos': (0.0, -0.17, 0.06), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 1.661080485, 'ipos': (0.08, -0.08, -0.08), 'iquat': (0.888073834, -0.325057584, -0.325057584, 0.0), 'inertia': (0.015905542, 0.015905542, 0.001285971)},
 {'name': 'lower_arm_right', 'parent': 10, 'pos': (0.18, -0.18, -0.18), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 0.96145762, 'ipos': (0.09, 0.09, 0.09), 'iquat': (0.459700843, 0.62796303, -0.62796303, 0.0), 'inertia': (0.008401616, 0.008401616, 0.000449988)},
 {'name': 'hand_right', 'parent': 11, 'pos': (0.18, 0.18, 0.18), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 0.268082573, 'ipos': (0.0, 0.0, 0.0), 'iquat': (0.888073834, -0.325057584, 0.325057584, 0.0), 'inertia': (0.000171573, 0.000171573, 0.000171573)},
 {'name': 'upper_arm_left', 'parent': 0, 'pos': (0.0, 0.17, 0.06), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 1.661080485, 'ipos': (0.08, 0.08, -0.08), 'iquat': (0.888073834, 0.325057584, -0.325057584, 0.0), 'inertia': (0.015905542, 0.015905542, 0.001285971)},
 {'name': 'lower_arm_left', 'parent': 13, 'pos': (0.18, 0.18, -0.18), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 0.96145762, 'ipos': (0.09, -0.09, 0.09), 'iquat': (0.459700843, -0.62796303, -0.62796303, 0.0), 'inertia': (0.008401616, 0.008401616, 0.000449988)},
 {'name': 'hand_left', 'parent': 14, 'pos': (0.18, -0.18, 0.18), 'quat': (1.0, 0.0, 0.0, 0.0), 'mass': 0.268082573, 'ipos': (0.0, 0.0, 0.0), 'iquat': (0.888073834, 0.325057584, 0.325057584, -0.0), 'inertia': (0.000171573, 0.000171573, 0.000171573)}]

JOINTS = [{'name': 'root', 'body': 0, 'jtype': 0, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 0.0, 1.0), 'jrange': (0.0, 0.0), 'limited': False, 'damping': 0.0, 'stiffness': 0.0, 'armature': 0.0},
 {'name': 'abdomen_z', 'body': 2, 'jtype': 3, 'pos': (0.0, 0.0, 0.065), 'axis': (0.0, 0.0, 1.0), 'jrange': (-0.785398163, 0.785398163), 'limited': True, 'damping': 5.0, 'stiffness': 20.0, 'armature': 0.01},
 {'name': 'abdomen_y', 'body': 2, 'jtype': 3, 'pos': (0.0, 0.0, 0.065), 'axis': (0.0, 1.0, 0.0), 'jrange': (-1.308996939, 0.523598776), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'abdomen_x', 'body': 3, 'jtype': 3, 'pos': (0.0, 0.0, 0.1), 'axis': (1.0, 0.0, 0.0), 'jrange': (-0.610865238, 0.610865238), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'hip_x_right', 'body': 4, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (1.0, 0.0, 0.0), 'jrange': (-0.523598776, 0.174532925), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'hip_z_right', 'body': 4, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 0.0, 1.0), 'jrange': (-1.047197551, 0.610865238), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'hip_y_right', 'body': 4, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 1.0, 0.0), 'jrange': (-2.617993878, 0.34906585), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'knee_right', 'body': 5, 'jtype': 3, 'pos': (0.0, 0.0, 0.02), 'axis': (0.0, -1.0, 0.0), 'jrange': (-2.792526803, 0.034906585), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'ankle_y_right', 'body': 6, 'jtype': 3, 'pos': (0.0, 0.0, 0.08), 'axis': (0.0, 1.0, 0.0), 'jrange': (-0.872664626, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 6.0, 'armature': 0.01},
 {'name': 'ankle_x_right', 'body': 6, 'jtype': 3, 'pos': (0.0, 0.0, 0.04), 'axis': (0.894427191, 0.0, 0.447213595), 'jrange': (-0.872664626, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 3.0, 'armature': 0.01},
 {'name': 'hip_x_left', 'body': 7, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (-1.0, 0.0, 0.0), 'jrange': (-0.523598776, 0.174532925), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'hip_z_left', 'body': 7, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 0.0, -1.0), 'jrange': (-1.047197551, 0.610865238), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'hip_y_left', 'body': 7, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 1.0, 0.0), 'jrange': (-2.617993878, 0.34906585), 'limited': True, 'damping': 5.0, 'stiffness': 10.0, 'armature': 0.01},
 {'name': 'knee_left', 'body': 8, 'jtype': 3, 'pos': (0.0, 0.0, 0.02), 'axis': (0.0, -1.0, 0.0), 'jrange': (-2.792526803, 0.034906585), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'ankle_y_left', 'body': 9, 'jtype': 3, 'pos': (0.0, 0.0, 0.08), 'axis': (0.0, 1.0, 0.0), 'jrange': (-0.872664626, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 6.0, 'armature': 0.01},
 {'name': 'ankle_x_left', 'body': 9, 'jtype': 3, 'pos': (0.0, 0.0, 0.04), 'axis': (-0.894427191, 0.0, -0.447213595), 'jrange': (-0.872664626, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 3.0, 'armature': 0.01},
 {'name': 'shoulder1_right', 'body': 10, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.816496581, 0.40824829, 0.40824829), 'jrange': (-1.483529864, 1.047197551), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'shoulder2_right', 'body': 10, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, -0.707106781, 0.707106781), 'jrange': (-1.483529864, 1.047197551), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'elbow_right', 'body': 11, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, -0.707106781, 0.707106781), 'jrange': (-1.745329252, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 0.0, 'armature': 0.01},
 {'name': 'shoulder1_left', 'body': 13, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (-0.816496581, 0.40824829, -0.40824829), 'jrange': (-1.483529864, 1.047197551), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'shoulder2_left', 'body': 13, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, -0.707106781, -0.707106781), 'jrange': (-1.483529864, 1.047197551), 'limited': True, 'damping': 0.2, 'stiffness': 1.0, 'armature': 0.01},
 {'name': 'elbow_left', 'body': 14, 'jtype': 3, 'pos': (0.0, 0.0, 0.0), 'axis': (0.0, -0.707106781, -0.707106781), 'jrange': (-1.745329252, 0.872664626), 'limited': True, 'damping': 0.2, 'stiffness': 0.0, 'armature': 0.01}]

GEOMS = [{'name': 'torso', 'body': 0, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, 0.07, -0.0), 'p1': (0.0, -0.07, 0.0), 'radius': 0.07},
 {'name': 'waist_upper', 'body': 0, 'friction': 0.7, 'kind': 'capsule', 'p0': (-0.01, 0.06, -0.12), 'p1': (-0.01, -0.06, -0.12), 'radius': 0.06},
 {'name': 'head', 'body': 1, 'friction': 0.7, 'kind': 'sphere', 'pos': (0.0, 0.0, 0.0), 'radius': 0.09},
 {'name': 'waist_lower', 'body': 2, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, 0.06, -0.0), 'p1': (0.0, -0.06, 0.0), 'radius': 0.06},
 {'name': 'butt', 'body': 3, 'friction': 0.7, 'kind': 'capsule', 'p0': (-0.02, 0.07, -0.0), 'p1': (-0.02, -0.07, 0.0), 'radius': 0.09},
 {'name': 'thigh_right', 'body': 4, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, 0.01, -0.34), 'p1': (0.0, 0.0, -0.0), 'radius': 0.06},
 {'name': 'shin_right', 'body': 5, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, 0.0, -0.3), 'p1': (0.0, 0.0, 0.0), 'radius': 0.049},
 {'name': 'foot1_right', 'body': 6, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.14, -0.03, -0.0), 'p1': (-0.07, -0.01, 0.0), 'radius': 0.027},
 {'name': 'foot2_right', 'body': 6, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.14, 0.03, -0.0), 'p1': (-0.07, 0.01, 0.0), 'radius': 0.027},
 {'name': 'thigh_left', 'body': 7, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, -0.01, -0.34), 'p1': (0.0, 0.0, -0.0), 'radius': 0.06},
 {'name': 'shin_left', 'body': 8, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.0, 0.0, -0.3), 'p1': (0.0, 0.0, 0.0), 'radius': 0.049},
 {'name': 'foot1_left', 'body': 9, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.14, -0.03, -0.0), 'p1': (-0.07, -0.01, 0.0), 'radius': 0.027},
 {'name': 'foot2_left', 'body': 9, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.14, 0.03, -0.0), 'p1': (-0.07, 0.01, 0.0), 'radius': 0.027},
 {'name': 'upper_arm_right', 'body': 10, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.16, -0.16, -0.16), 'p1': (0.0, 0.0, 0.0), 'radius': 0.04},
 {'name': 'lower_arm_right', 'body': 11, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.17, 0.17, 0.17), 'p1': (0.01, 0.01, 0.01), 'radius': 0.031},
 {'name': 'hand_right', 'body': 12, 'friction': 0.7, 'kind': 'sphere', 'pos': (0.0, 0.0, 0.0), 'radius': 0.04},
 {'name': 'upper_arm_left', 'body': 13, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.16, 0.16, -0.16), 'p1': (0.0, 0.0, 0.0), 'radius': 0.04},
 {'name': 'lower_arm_left', 'body': 14, 'friction': 0.7, 'kind': 'capsule', 'p0': (0.17, -0.17, 0.17), 'p1': (0.01, -0.01, 0.01), 'radius': 0.031},
 {'name': 'hand_left', 'body': 15, 'friction': 0.7, 'kind': 'sphere', 'pos': (0.0, 0.0, 0.0), 'radius': 0.04}]

SITES = [{'name': 'tracking[head]', 'body': 1, 'pos': (0.09, 0.0, 0.0)},
         # full mocap-tracking marker set (humanoid.xml.patch
         # tracking_site class; heel/toe markers take the patch's
         # massless heel/toe body offsets inside the foot bodies)
         {'name': 'tracking[rhip]', 'body': 4, 'pos': (0.0, 0.025, 0.025)},
         {'name': 'tracking[rknee]', 'body': 5, 'pos': (0.0, 0.0, 0.05)},
         {'name': 'tracking[rheel]', 'body': 6, 'pos': (-0.05, 0.0, 0.04)},
         {'name': 'tracking[rtoe]', 'body': 6, 'pos': (0.07, 0.0, -0.01)},
         {'name': 'tracking[lhip]', 'body': 7, 'pos': (0.0, -0.025, 0.025)},
         {'name': 'tracking[lknee]', 'body': 8, 'pos': (0.0, 0.0, 0.05)},
         {'name': 'tracking[lheel]', 'body': 9, 'pos': (-0.05, 0.0, 0.04)},
         {'name': 'tracking[ltoe]', 'body': 9, 'pos': (0.07, 0.0, -0.01)},
         {'name': 'tracking[rshoulder]', 'body': 10, 'pos': (0.0, 0.0, 0.0)},
         {'name': 'tracking[relbow]', 'body': 11, 'pos': (0.0, 0.0, 0.0)},
         {'name': 'tracking[lshoulder]', 'body': 13, 'pos': (0.0, 0.0, 0.0)},
         {'name': 'tracking[lelbow]', 'body': 14, 'pos': (0.0, 0.0, 0.0)},
 {'name': 'tracking[pelvis]', 'body': 3, 'pos': (0.0, 0.0, 0.075)},
 {'name': 'foot_right', 'body': 6, 'pos': (0.05, 0.03, 0.0)},
 {'name': 'sp2', 'body': 6, 'pos': (-0.07, 0.0, 0.0)},
 {'name': 'sp3', 'body': 6, 'pos': (0.14, 0.0, 0.0)},
 {'name': 'foot_left', 'body': 9, 'pos': (0.05, -0.03, 0.0)},
 {'name': 'sp0', 'body': 9, 'pos': (-0.07, 0.0, 0.0)},
 {'name': 'sp1', 'body': 9, 'pos': (0.14, 0.0, 0.0)},
 {'name': 'tracking[rhand]', 'body': 11, 'pos': (0.13, 0.13, 0.13)},
 {'name': 'tracking[lhand]', 'body': 14, 'pos': (0.13, -0.13, 0.13)}]

ACTUATORS = [{'name': 'abdomen_y', 'joint': 'abdomen_y', 'gear': 40.0},
 {'name': 'abdomen_z', 'joint': 'abdomen_z', 'gear': 40.0},
 {'name': 'abdomen_x', 'joint': 'abdomen_x', 'gear': 40.0},
 {'name': 'hip_x_right', 'joint': 'hip_x_right', 'gear': 40.0},
 {'name': 'hip_z_right', 'joint': 'hip_z_right', 'gear': 40.0},
 {'name': 'hip_y_right', 'joint': 'hip_y_right', 'gear': 120.0},
 {'name': 'knee_right', 'joint': 'knee_right', 'gear': 100.0},
 {'name': 'ankle_x_right', 'joint': 'ankle_x_right', 'gear': 20.0},
 {'name': 'ankle_y_right', 'joint': 'ankle_y_right', 'gear': 20.0},
 {'name': 'hip_x_left', 'joint': 'hip_x_left', 'gear': 40.0},
 {'name': 'hip_z_left', 'joint': 'hip_z_left', 'gear': 40.0},
 {'name': 'hip_y_left', 'joint': 'hip_y_left', 'gear': 120.0},
 {'name': 'knee_left', 'joint': 'knee_left', 'gear': 100.0},
 {'name': 'ankle_x_left', 'joint': 'ankle_x_left', 'gear': 20.0},
 {'name': 'ankle_y_left', 'joint': 'ankle_y_left', 'gear': 20.0},
 {'name': 'shoulder1_right', 'joint': 'shoulder1_right', 'gear': 20.0},
 {'name': 'shoulder2_right', 'joint': 'shoulder2_right', 'gear': 20.0},
 {'name': 'elbow_right', 'joint': 'elbow_right', 'gear': 40.0},
 {'name': 'shoulder1_left', 'joint': 'shoulder1_left', 'gear': 20.0},
 {'name': 'shoulder2_left', 'joint': 'shoulder2_left', 'gear': 20.0},
 {'name': 'elbow_left', 'joint': 'elbow_left', 'gear': 40.0}]

TENDONS = [{'joints': ('hip_y_right', 'knee_right'), 'coefs': (0.5, -0.5), 'range': (-0.3, 2.0)},
 {'joints': ('hip_y_left', 'knee_left'), 'coefs': (0.5, -0.5), 'range': (-0.3, 2.0)}]
